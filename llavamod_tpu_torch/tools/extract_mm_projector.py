"""Extract the mm projector from a full checkpoint into mm_projector.bin
(port of llavamod_tpu/tools/extract_mm_projector.py).

Mirror of reference scripts/extract_mm_projector.py:26-46 — accepts either a
torch checkpoint dir/file (keys filtered on 'mm_projector') or one of the
port's native model dirs (projector re-exported in the reference layout,
`train/checkpoint.py::save_mm_projector`).

  python -m llavamod_tpu_torch.tools.extract_mm_projector --model-path CKPT \
      --output mm_projector.bin
"""

from __future__ import annotations

import argparse
import os

import torch


def extract_mm_projector(model_path: str, output: str) -> str:
    from llavamod_tpu_torch.models.builder import CONFIG_NAME

    if os.path.isdir(model_path) and os.path.exists(
            os.path.join(model_path, CONFIG_NAME)):
        from llavamod_tpu_torch.models.builder import load_model
        from llavamod_tpu_torch.train.checkpoint import save_mm_projector

        # the projector alone is read: the host is enough
        cfg, model = load_model(model_path, device="cpu")
        return save_mm_projector(output, model.projector.state_dict(),
                                 cfg.projector_type)

    if os.path.isdir(model_path):
        names = [n for n in sorted(os.listdir(model_path))
                 if n.endswith(".bin") and "optimizer" not in n]
        state = {}
        for n in names:
            state.update(torch.load(os.path.join(model_path, n),
                                    map_location="cpu", weights_only=True,
                                    mmap=True))
    else:
        state = torch.load(model_path, map_location="cpu", weights_only=True,
                           mmap=True)
    proj = {k: v.float() for k, v in state.items() if "mm_projector" in k}
    if not proj:
        raise KeyError(f"no mm_projector keys found in {model_path}")
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    torch.save(proj, output)
    return output


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="llavamod_tpu_torch.tools.extract_mm_projector")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    path = extract_mm_projector(args.model_path, args.output)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
