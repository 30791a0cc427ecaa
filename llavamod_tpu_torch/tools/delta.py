"""Weight-delta tools: make / apply vicuna-style deltas (port of
llavamod_tpu/tools/delta.py).

Functional port of the reference's model/apply_delta.py:13-38 and
model/make_delta.py semantics on the port's state dicts:

  * entries present only in the delta (e.g. the mm projector, new special-
    token embedding rows) pass through unchanged;
  * vocab-resized embedding/lm_head matrices add the base into the
    top-left block (apply) / subtract it (make).

CLI:
  python -m llavamod_tpu_torch.tools.delta apply --base B --delta D --target OUT
  python -m llavamod_tpu_torch.tools.delta make  --base B --target T --delta OUT
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

_RESIZABLE = ("embed.embedding", "lm_head.weight")


def _combine(delta: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor],
             sign: float) -> Dict[str, torch.Tensor]:
    """target = delta + sign * base, tolerating missing/resized entries."""
    out = {}
    for k, d in delta.items():
        if k not in base:
            # projector / new modules exist only in the delta
            out[k] = d
            continue
        b = base[k]
        if d.shape == b.shape:
            out[k] = d + sign * b
            continue
        if not k.endswith(_RESIZABLE):
            raise ValueError(f"{k} dimension mismatch: {tuple(d.shape)} vs "
                             f"{tuple(b.shape)}")
        o = d.clone()
        o[: b.shape[0], : b.shape[1]] += sign * b
        out[k] = o
    return out


def apply_delta(base: Dict[str, torch.Tensor],
                delta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """target = base + delta (apply_delta.py:24-34)."""
    return _combine(delta, base, +1.0)


def make_delta(base: Dict[str, torch.Tensor],
               target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """delta = target - base (make_delta.py)."""
    return _combine(target, base, -1.0)


def main(argv=None, device="cuda") -> None:
    from llavamod_tpu_torch.models.builder import (
        from_state,
        load_model,
        save_model,
    )

    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.tools.delta")
    ap.add_argument("mode", choices=["apply", "make"])
    ap.add_argument("--base", required=True)
    ap.add_argument("--delta", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--device", default=device,
                    help="torch device of the arithmetic (default: the card)")
    args = ap.parse_args(argv)

    def state(path):
        cfg, model = load_model(path, device=args.device)
        return cfg, model.state_dict()

    _, base = state(args.base)
    if args.mode == "apply":
        cfg, delta = state(args.delta)
        out, combined = args.target, apply_delta(base, delta)
    else:
        cfg, target = state(args.target)
        out, combined = args.delta, make_delta(base, target)
    save_model(out, from_state(cfg, combined, out, args.device, None, None))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
