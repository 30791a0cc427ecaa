#!/bin/bash
# Q-Bench (LLVisionQA dev split): multiple-choice low-level-vision QA
# (reference llavamod/eval/model_vqa_qbench.py).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
LANG=${LANG_SPLIT:-en}
NAME=$(basename "${MODEL_PATH}")

python -m llavamod_tpu_torch.eval.cli generate --task qbench \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/qbench/llvisionqa_dev.json" \
    --image-folder "${EVAL}/qbench/images_llvisionqa" \
    --answers-file "${EVAL}/qbench/llvisionqa_dev_${LANG}_answers/${NAME}.jsonl" \
    --lang "${LANG}" --temperature 0
