"""Mimic-distillation (KD) entry point, dense->dense and dense->sparse
(port of llavamod_tpu/train/align_train.py; the reference's
`llavamod/train/align_train.py`):

    python -m llavamod_tpu_torch.train.align_train \
        --policy_model_name_or_path <student> --ref_model_name_or_path <teacher> \
        --policy_model_type sparse --moe_enable true --loss_type only_kd \
        --train_modules mlp.gate_proj mlp.up_proj mlp.down_proj wg \
        --data_path ... --output_dir ...
"""

from llavamod_tpu_torch.train.run import main

if __name__ == "__main__":
    main(stage="align")
