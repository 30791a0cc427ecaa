#!/bin/bash
# VizWiz submission (reference shells/eval/vizwiz.sh).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/vizwiz/llava_test.jsonl" \
    --image-folder "${EVAL}/vizwiz/test" \
    --answers-file "${EVAL}/vizwiz/answers/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli convert --benchmark vizwiz \
    --answers "${EVAL}/vizwiz/answers/${NAME}.jsonl" \
    --test-questions "${EVAL}/vizwiz/llava_test.jsonl" \
    --output "${EVAL}/vizwiz/answers_upload/${NAME}.json"
