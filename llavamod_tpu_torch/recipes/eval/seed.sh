#!/bin/bash
# SEED-Bench: generic VQA generation + submission converter
# (reference scripts/convert_seed_for_submission.py; upstream LLaVA recipe —
# the reference ships the converter without a shell).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
SPLIT=${SPLIT:-llava-seed-bench}
NAME=$(basename "${MODEL_PATH}")
ANS=${EVAL}/seed_bench/answers/${SPLIT}

python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/seed_bench/${SPLIT}.jsonl" \
    --image-folder "${EVAL}/seed_bench" \
    --answers-file "${ANS}/${NAME}.jsonl" --temperature 0

python -m llavamod_tpu_torch.eval.cli convert --benchmark seed \
    --answers "${ANS}/${NAME}.jsonl" \
    --annotations "${EVAL}/seed_bench/SEED-Bench.json" \
    --output "${EVAL}/seed_bench/answers_upload/${NAME}.jsonl"
