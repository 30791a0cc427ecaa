#!/bin/bash
# MME perception/cognition suite (reference shells/eval/mme.sh).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/MME/llava_mme.jsonl" \
    --image-folder "${EVAL}/MME/MME_Benchmark_release_version" \
    --answers-file "${EVAL}/MME/answers/${NAME}.jsonl" --temperature 0
python -m llavamod_tpu_torch.eval.cli score --benchmark mme \
    --answers "${EVAL}/MME/answers/${NAME}.jsonl"
