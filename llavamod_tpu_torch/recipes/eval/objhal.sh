#!/bin/bash
# Object-HalBench: generate then CHAIR via the judge machinery
# (reference shells/eval/objhal.sh + eval_gpt_objhal.py).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task objhal \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/objhal/obj_halbench_300_with_image.jsonl" \
    --answers-file "${EVAL}/objhal/answers/${NAME}.jsonl" --temperature 0
echo "CHAIR: use llavamod_tpu_torch.eval.gpt_judge.compute_chair on extracted objects"
