#!/bin/bash
# ScienceQA (reference shells/eval/sqa.sh).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task sqa \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/scienceqa/llava_test_CQM-A.json" \
    --image-folder "${EVAL}/scienceqa/images/test" \
    --answers-file "${EVAL}/scienceqa/answers/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli score --benchmark sqa \
    --annotations "${EVAL}/scienceqa/problems.json" \
    --answers "${EVAL}/scienceqa/answers/${NAME}.jsonl"
