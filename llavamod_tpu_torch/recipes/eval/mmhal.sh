#!/bin/bash
# MMHal-Bench: generate then judge with an LLM (reference shells/eval/mmhal.sh
# + eval_gpt_mmhal.py; plug any judge via llavamod_tpu_torch.eval.gpt_judge).
set -e
MODEL_PATH=${MODEL_PATH:?}; EVAL=${EVAL:-'./playground/eval'}
NAME=$(basename "${MODEL_PATH}")
python -m llavamod_tpu_torch.eval.cli generate --task mmhal \
    --model-path "${MODEL_PATH}" \
    --question-file "${EVAL}/mmhal/response_template.jsonl" \
    --image-folder "${EVAL}/mmhal/images" \
    --answers-file "${EVAL}/mmhal/answers/${NAME}.jsonl" --temperature 0
echo "judge: python -c 'from llavamod_tpu_torch.eval.gpt_judge import *' (see docstring)"
