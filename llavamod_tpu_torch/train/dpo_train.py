"""Preference-distillation (DPO / KTO-pair) entry point (port of
llavamod_tpu/train/dpo_train.py; the reference's
`llavamod/train/dpo_train.py`):

    python -m llavamod_tpu_torch.train.dpo_train \
        --policy_model_name_or_path <student> --ref_model_name_or_path <teacher> \
        --loss_type kto_pair --data_path rlaif_pairs.json --output_dir ...
"""

from llavamod_tpu_torch.train.run import main

if __name__ == "__main__":
    main(stage="dpo")
