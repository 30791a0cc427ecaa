"""Stage-1 pretrain / SFT / MoE-SFT entry point (port of
llavamod_tpu/train/train.py; the reference's `llavamod/train/train.py`):

    python -m llavamod_tpu_torch.train.train --model_name_or_path ... \
        --data_path ... --tune_mm_mlp_adapter true --output_dir ...

Set --moe_enable true --moe_finetune false for MoE-SFT upcycling.
"""

from llavamod_tpu_torch.train.run import main

if __name__ == "__main__":
    main(stage="pretrain")
