"""Consolidate a loadable checkpoint (HF import or native) into one native
directory (port of llavamod_tpu/tools/consolidate.py; reference
model/consolidate.py:14-21).  A LoRA base (`--base`) is not ported yet.

  python -m llavamod_tpu_torch.tools.consolidate --src PATH [--base BASE] \
      --dst OUT [--device cuda]
"""

from __future__ import annotations

import argparse
import os


def consolidate_ckpt(src: str, dst: str, base: str = None,
                     device="cuda") -> str:
    from llavamod_tpu_torch.models.builder import (
        CONFIG_NAME,
        import_hf_llava,
        load_model,
        not_ported,
        save_model,
    )

    if base is not None:
        raise not_ported(f"merging LoRA weights onto --base {base}", 6)
    if os.path.exists(os.path.join(src, CONFIG_NAME)):
        _, model = load_model(src, device=device)
    else:
        # an HF LLaVA directory holds no tower: the native copy has none
        # either, as the JAX tool writes it
        _, model = import_hf_llava(src, device=device)
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
