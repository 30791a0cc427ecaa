#!/bin/bash
# Stage 3 — preference distillation (KTO-pair on RLAIF-V pairs).
# Mirror of reference shells/train/qwen/preference_distillation.sh
# (loss kto_pair, lr 2e-6, bs 1 x accum 8).
set -e
JSON_FILE=${JSON_FILE:-'your_rlaif_pairs_json'}
IMAGE_FOLDER=${IMAGE_FOLDER:-'your_image_folder'}
REF_MLLM=${REF_MLLM:-'your_teacher_checkpoint'}
POLICY_MLLM=${POLICY_MLLM:-'./checkpoints/llavaqwen-2-0.5b-d2s'}
OUTPUT_DIR=${OUTPUT_DIR:-'./checkpoints/llavaqwen-2-0.5b-pref'}

python -m llavamod_tpu_torch.train.dpo_train \
    --ref_model_name_or_path "${REF_MLLM}" \
    --policy_model_name_or_path "${POLICY_MLLM}" \
    --policy_model_type sparse --ref_model_type dense \
    --loss_type kto_pair --moe_loss_enable true \
    --version qwen \
    --data_path "${JSON_FILE}" \
    --image_folder "${IMAGE_FOLDER}" \
    --image_tower clip-vit-l-336 \
    --output_dir "${OUTPUT_DIR}" \
    --num_train_epochs 1 \
    --per_device_train_batch_size 1 \
    --gradient_accumulation_steps 8 \
    --save_steps 10000 --save_total_limit 2 \
    --learning_rate 2e-6 \
    --warmup_ratio 0.03 --lr_scheduler_type cosine \
    --logging_steps 1 --model_max_length 2048 \
    --dataloader_num_workers 8
