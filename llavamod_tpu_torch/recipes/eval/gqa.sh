#!/bin/bash
# GQA: generate (chunk fan-out optional) -> merge -> convert -> full score.
# Mirror of reference shells/eval/gqa.sh:17-49 on the port's eval CLI;
# one batched process replaces the 4 per-GPU deepspeed launches.
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
SPLIT=${SPLIT:-llava_gqa_testdev_balanced}
IMAGE_FOLDER=${IMAGE_FOLDER:-${EVAL}/gqa/images}
NAME=$(basename "${MODEL_PATH}")
ANS=${EVAL}/gqa/answers/${SPLIT}/${NAME}

python -m llavamod_tpu_torch.eval.cli generate --task generic \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/gqa/${SPLIT}.jsonl" \
    --image-folder "${IMAGE_FOLDER}" \
    --answers-file "${ANS}/merge.jsonl" \
    --temperature 0 --batch-size 8

python -m llavamod_tpu_torch.eval.cli convert --benchmark gqa \
    --answers "${ANS}/merge.jsonl" \
    --output "${ANS}/testdev_balanced_predictions.json"

python -m llavamod_tpu_torch.eval.cli score --benchmark gqa --full \
    --question-file "${EVAL}/gqa/data/testdev_balanced_questions.json" \
    --answers "${ANS}/testdev_balanced_predictions.json"
