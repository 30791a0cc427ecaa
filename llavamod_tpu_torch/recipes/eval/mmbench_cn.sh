#!/bin/bash
# MMBench-CN: the Chinese split of MMBench (reference shells/eval/mmbench_cn.sh);
# same TSV+base64 pipeline as mmbench.sh with --lang cn.
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
SPLIT=${SPLIT:-mmbench_dev_cn_20231003}
NAME=$(basename "${MODEL_PATH}")
ANS=${EVAL}/mmbench/answers/${SPLIT}

python -m llavamod_tpu_torch.eval.cli generate --task mmbench \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/mmbench/${SPLIT}.tsv" \
    --answers-file "${ANS}/${NAME}.jsonl" \
    --lang cn --temperature 0

python -m llavamod_tpu_torch.eval.cli convert --benchmark mmbench \
    --answers "${ANS}/${NAME}.jsonl" \
    --test-questions "${EVAL}/mmbench/${SPLIT}.tsv" \
    --output "${EVAL}/mmbench/answers_upload/${SPLIT}/${NAME}.xlsx"
