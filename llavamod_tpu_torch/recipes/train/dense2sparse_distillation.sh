#!/bin/bash
# Stage 2b — mimic distillation, sparse-upcycled MoE student <- dense teacher.
# Mirror of reference shells/train/qwen/dense2sparse_distillation.sh:
# 4 experts top-2, capacity 1.5, MoE on every 2nd layer, aux coef 0.01,
# trainable = FFN experts + router (wg); lr 2e-5, bs 1 x accum 8.
set -e
JSON_FILE=${JSON_FILE:-'your_multitask_json'}
IMAGE_FOLDER=${IMAGE_FOLDER:-'your_image_folder'}
REF_MLLM=${REF_MLLM:-'your_teacher_checkpoint'}
POLICY_MLLM=${POLICY_MLLM:-'./checkpoints/llavaqwen-2-0.5b-d2d'}
OUTPUT_DIR=${OUTPUT_DIR:-'./checkpoints/llavaqwen-2-0.5b-d2s'}

python -m llavamod_tpu_torch.train.align_train \
    --ref_model_name_or_path "${REF_MLLM}" \
    --policy_model_name_or_path "${POLICY_MLLM}" \
    --policy_model_type sparse --ref_model_type dense \
    --loss_type kd_lm --distill_all_tokens false \
    --moe_loss_enable true --moe_enable true \
    --num_experts 4 --top_k_experts 2 --capacity_factor 1.5 \
    --moe_mode sparse --use_residual false --router_aux_loss_coef 0.01 \
    --train_modules mlp.gate_proj mlp.up_proj mlp.down_proj wg \
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
    --dataloader_num_workers 8 \
    --ref_quant int8_head \
    --policy_head_quant true
# --ref_quant int8_head runs the frozen teacher, its LM head included, in
# W8A8; --policy_head_quant runs the frozen student head in int8 (valid
# because train_modules above freezes the head).
# On N cards, one process per card (data x fsdp x expert = N; the ranks
# --expert_parallel leaves over shard the parameters, FSDP2 / ZeRO-3):
#   torchrun --nproc_per_node N -m llavamod_tpu_torch.train.run \
#       --stage align <the flags above> --expert_parallel 2
