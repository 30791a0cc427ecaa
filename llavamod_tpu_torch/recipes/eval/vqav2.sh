#!/bin/bash
# VQAv2 test-dev submission (reference shells/eval pattern + convert_vqav2).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
SPLIT=${SPLIT:-llava_vqav2_mscoco_test-dev2015}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/vqav2/${SPLIT}.jsonl" \
    --image-folder "${EVAL}/vqav2/test2015" \
    --answers-file "${EVAL}/vqav2/answers/${SPLIT}/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli convert --benchmark vqav2 \
    --answers "${EVAL}/vqav2/answers/${SPLIT}/${NAME}.jsonl" \
    --test-questions "${EVAL}/vqav2/${SPLIT}.jsonl" \
    --output "${EVAL}/vqav2/answers_upload/${SPLIT}/${NAME}.json"
