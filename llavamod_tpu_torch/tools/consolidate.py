"""Consolidate a loadable checkpoint (HF import, LoRA adapter + base, or
native) into one native directory (port of llavamod_tpu/tools/consolidate.py;
reference model/consolidate.py:14-21).  With `--base`, `--src` is a LoRA
adapter directory merged onto the base model read from `--base`, native
or HF (a base without a tower included, as the JAX merge_lora tool takes
it).

  python -m llavamod_tpu_torch.tools.consolidate --src PATH [--base BASE] \
      --dst OUT [--device cuda]
"""

from __future__ import annotations

import argparse


def consolidate_ckpt(src: str, dst: str, base: str = None,
                     device="cuda") -> str:
    from llavamod_tpu_torch.models.builder import load_any, save_model
    from llavamod_tpu_torch.models.lora import merge_lora_checkpoint

    # an HF LLaVA directory holds no tower: the native copy has none
    # either, as the JAX tool writes it
    if base is not None:
        _, model = merge_lora_checkpoint(
            src, *load_any(base, device, complete=False))
    else:
        _, model = load_any(src, device, complete=False)
    return save_model(dst, model)


def main(argv=None, device="cuda") -> str:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.tools.consolidate")
    ap.add_argument("--src", required=True)
    ap.add_argument("--base", default=None)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--device", default=device,
                    help="torch device of the load (default: the card)")
    args = ap.parse_args(argv)
    path = consolidate_ckpt(args.src, args.dst, args.base, args.device)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
