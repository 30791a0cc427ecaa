#!/bin/bash
# Stage 1 — adaptor init (projector-only pretrain on captions).
# Mirror of reference shells/train/qwen/pretrain.sh: same hyperparams of
# record (lr 1e-3, bs 8 x accum 2, cosine, warmup 0.03, max_len 2048,
# bf16); one process on one GPU (no launcher).
set -e
JSON_FILE=${JSON_FILE:-'your_caption_json'}
IMAGE_FOLDER=${IMAGE_FOLDER:-'your_image_folder'}
LLM=${LLM:-'qwen2-0.5b'}          # preset name or HF/native checkpoint dir
OUTPUT_DIR=${OUTPUT_DIR:-'./checkpoints/llavaqwen-2-0.5b-pretrain'}

python -m llavamod_tpu_torch.train.train \
    --model_name_or_path "${LLM}" \
    --version plain \
    --data_path "${JSON_FILE}" \
    --image_folder "${IMAGE_FOLDER}" \
    --image_tower clip-vit-l-336 \
    --image_projector_type mlp2x_gelu \
    --tune_mm_mlp_adapter true \
    --mm_vision_select_layer -2 \
    --mm_use_im_start_end false \
    --output_dir "${OUTPUT_DIR}" \
    --num_train_epochs 1 \
    --per_device_train_batch_size 8 \
    --gradient_accumulation_steps 2 \
    --save_steps 10000 \
    --save_total_limit 2 \
    --learning_rate 1e-3 \
    --weight_decay 0.0 \
    --warmup_ratio 0.03 \
    --lr_scheduler_type cosine \
    --logging_steps 1 \
    --model_max_length 2048 \
    --dataloader_num_workers 8
