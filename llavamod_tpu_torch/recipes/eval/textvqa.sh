#!/bin/bash
# TextVQA (reference shells/eval/textvqa.sh).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/textvqa/llava_textvqa_val_v051_ocr.jsonl" \
    --image-folder "${EVAL}/textvqa/train_images" \
    --answers-file "${EVAL}/textvqa/answers/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli score --benchmark textvqa \
    --annotations "${EVAL}/textvqa/TextVQA_0.5.1_val.json" \
    --answers "${EVAL}/textvqa/answers/${NAME}.jsonl"
