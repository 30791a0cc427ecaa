#!/bin/bash
# POPE yes/no hallucination probe (reference shells/eval/pope.sh).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/pope/llava_pope_test.jsonl" \
    --image-folder "${EVAL}/pope/val2014" \
    --answers-file "${EVAL}/pope/answers/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli score --benchmark pope \
    --question-file "${EVAL}/pope/llava_pope_test.jsonl" \
    --answers "${EVAL}/pope/answers/${NAME}.jsonl" \
    --annotation-dir "${EVAL}/pope/coco"
