#!/bin/bash
# MM-Vet: generation + json converter for the official grader
# (reference scripts/convert_mmvet_for_eval.py; converter-only upstream).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
ANS=${EVAL}/mm-vet/answers

python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/mm-vet/llava-mm-vet.jsonl" \
    --image-folder "${EVAL}/mm-vet/images" \
    --answers-file "${ANS}/${NAME}.jsonl" --temperature 0

python -m llavamod_tpu_torch.eval.cli convert --benchmark mmvet \
    --answers "${ANS}/${NAME}.jsonl" \
    --output "${EVAL}/mm-vet/results/${NAME}.json"
