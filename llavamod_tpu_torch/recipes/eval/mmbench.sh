#!/bin/bash
# MMBench: TSV+base64 questions, circular option rounds, xlsx submission.
# Mirror of reference shells/eval/mmbench.sh.
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
SPLIT=${SPLIT:-mmbench_dev_20230712}
NAME=$(basename "${MODEL_PATH}")
ANS=${EVAL}/mmbench/answers/${SPLIT}

python -m llavamod_tpu_torch.eval.cli generate --task mmbench \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/mmbench/${SPLIT}.tsv" \
    --answers-file "${ANS}/${NAME}.jsonl" \
    --all-rounds --lang en --temperature 0

python -m llavamod_tpu_torch.eval.cli convert --benchmark mmbench \
    --answers "${ANS}/${NAME}.jsonl" \
    --test-questions "${EVAL}/mmbench/${SPLIT}.tsv" \
    --output "${EVAL}/mmbench/answers_upload/${SPLIT}/${NAME}.xlsx"
