#!/bin/bash
# Stage 2a — mimic distillation, dense student <- dense teacher.
# Mirror of reference shells/train/qwen/dense2dense_distillation.sh
# (lr 2e-5, bs 1 x accum 8, loss kd_lm, response tokens only).
set -e
JSON_FILE=${JSON_FILE:-'your_mimic_json'}
IMAGE_FOLDER=${IMAGE_FOLDER:-'your_image_folder'}
REF_MLLM=${REF_MLLM:-'your_teacher_checkpoint'}
POLICY_MLLM=${POLICY_MLLM:-'./checkpoints/llavaqwen-2-0.5b-pretrain'}
OUTPUT_DIR=${OUTPUT_DIR:-'./checkpoints/llavaqwen-2-0.5b-d2d'}

python -m llavamod_tpu_torch.train.align_train \
    --ref_model_name_or_path "${REF_MLLM}" \
    --policy_model_name_or_path "${POLICY_MLLM}" \
    --policy_model_type dense --ref_model_type dense \
    --loss_type kd_lm --distill_all_tokens false \
    --version qwen \
    --data_path "${JSON_FILE}" \
    --image_folder "${IMAGE_FOLDER}" \
    --image_tower clip-vit-l-336 \
    --output_dir "${OUTPUT_DIR}" \
    --num_train_epochs 1 \
    --per_device_train_batch_size 1 \
    --gradient_accumulation_steps 8 \
    --save_steps 10000 --save_total_limit 2 \
    --learning_rate 2e-5 \
    --warmup_ratio 0.03 --lr_scheduler_type cosine \
    --logging_steps 1 --model_max_length 2048 \
    --group_by_modality_length true \
    --dataloader_num_workers 8
