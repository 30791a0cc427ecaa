"""Merge LoRA adapters into base weights and save a standalone model (port
of llavamod_tpu/tools/merge_lora.py; reference scripts/merge_lora_weights.py
and scripts/merge_moe_lora_weights.py:31-85, expert adapters merged per
expert by models/lora.py's batched product).

  python -m llavamod_tpu_torch.tools.merge_lora --model-path ADAPTER_DIR \
      --model-base BASE_DIR --save-path OUT_DIR [--device cuda]

The base is a native or an HF checkpoint directory; the merged model is
written as a native one.
"""

from __future__ import annotations

import argparse


def merge_lora_weights(model_path: str, model_base: str, save_path: str,
                       device="cuda") -> str:
    from llavamod_tpu_torch.models.builder import load_any, save_model
    from llavamod_tpu_torch.models.lora import merge_lora_checkpoint

    _, model = merge_lora_checkpoint(
        model_path, *load_any(model_base, device, complete=False))
    return save_model(save_path, model)


def main(argv=None, device="cuda") -> str:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.tools.merge_lora")
    ap.add_argument("--model-path", required=True, help="adapter dir")
    ap.add_argument("--model-base", required=True)
    ap.add_argument("--save-path", required=True)
    ap.add_argument("--device", default=device,
                    help="torch device of the merge (default: the card)")
    args = ap.parse_args(argv)
    path = merge_lora_weights(args.model_path, args.model_base,
                              args.save_path, args.device)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
