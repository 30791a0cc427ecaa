"""Convert an HF checkpoint directory to the port's native checkpoint
(port of llavamod_tpu/tools/import_hf.py).

    python -m llavamod_tpu_torch.tools.import_hf --hf-path <dir> \
        --output <dir> [--vision-tower clip-vit-l-336] \
        [--projector mlp2x_gelu] [--seed 0] [--device cuda]

Works for every supported LLM family (interop/hf.py SUPPORTED_MODEL_TYPES):
the state-dict layout is auto-detected (llama-style, gemma2, phi, stablelm,
qwen-1.0 fused c_attn, MPT fused Wqkv) and an unknown layout fails with a
ValueError naming the supported types.  If the HF config carries the
reference's multimodal fields (mm_image_tower / mm_projector_type /
embedded moe block, llava_qwen1_5_moe.py:48-81), those are honored;
otherwise a text-only LLaVA shell is written with a fresh projector and the
named (frozen) vision tower, seeded, i.e. a stage-1-ready init — exactly
what the reference's pretrain stage starts from.  A tower embedded in the
checkpoint (`vision_model.*` keys) is restored.  The weights keep the
file's dtype; the conversion runs on `--device` (the card by default).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch


def _load_state(hf_path: str) -> dict:
    """The full state dict of pytorch_model*.bin / *.safetensors shards
    (the .bin files first, as the JAX tool), memory-mapped."""
    from llavamod_tpu_torch.interop.safetensors_io import read_safetensors

    bins = sorted(glob.glob(os.path.join(hf_path, "pytorch_model*.bin")))
    safes = sorted(glob.glob(os.path.join(hf_path, "*.safetensors")))
    state = {}
    if bins:
        for b in bins:
            state.update(torch.load(b, map_location="cpu", weights_only=True,
                                    mmap=True))
    elif safes:
        for s in safes:
            state.update(read_safetensors(s))
    else:
        raise FileNotFoundError(
            f"no pytorch_model*.bin or *.safetensors under {hf_path}")
    return state


def main(argv=None, device="cuda") -> str:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.tools.import_hf")
    ap.add_argument("--hf-path", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--vision-tower", default=None,
                    help="tower name if the HF config has no mm_image_tower")
    ap.add_argument("--projector", default=None,
                    help="projector spec if the HF config has none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=device,
                    help="torch device of the conversion (default: the card)")
    args = ap.parse_args(argv)

    from llavamod_tpu_torch.interop import hf
    from llavamod_tpu_torch.models.builder import from_state, save_model
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.vision.vit import vision_configs

    hf_cfg = hf.load_hf_config(args.hf_path)
    llm_cfg = hf.decoder_config_from_hf(hf_cfg)
    state = _load_state(args.hf_path)

    tower = (getattr(hf_cfg, "mm_image_tower", None)
             or getattr(hf_cfg, "mm_vision_tower", None)
             or args.vision_tower or "clip-vit-l-336")
    proj = (getattr(hf_cfg, "mm_projector_type", None)
            or args.projector or "mlp2x_gelu")
    cfg = LlavaConfig(
        llm=llm_cfg, vision=vision_configs.get(tower), projector_type=proj,
        select_layer=getattr(hf_cfg, "mm_vision_select_layer", -2),
        select_feature=getattr(hf_cfg, "mm_vision_select_feature", "patch"),
        image_aspect_ratio=getattr(hf_cfg, "image_aspect_ratio", "pad"),
        max_images=1)

    out = hf.prefixed("llm", hf.decoder_params_from_hf(
        state, llm_cfg, device=args.device))
    mm_keys = [k for k in state if "mm_projector" in k]
    if mm_keys:
        out.update(hf.prefixed("projector", hf.projector_params_from_hf(
            {k: state[k] for k in mm_keys}, proj, device=args.device)))
        print(f"[import] projector restored from {len(mm_keys)} keys")
    vt_keys = [k for k in state if "vision_model." in k]
    if vt_keys:
        prefix = ("vision_tower.vision_tower.vision_model."
                  if any(k.startswith("vision_tower.") for k in vt_keys)
                  else "vision_model.")
        out.update(hf.prefixed("vision", hf.vision_params_from_hf(
            state, cfg.vision, prefix=prefix, device=args.device)))
        print(f"[import] vision tower restored from {len(vt_keys)} keys")
    # groups the checkpoint lacks: a fresh seeded shell
    model = from_state(cfg, out, args.hf_path, args.device, None,
                       fill_missing_seed=args.seed)
    path = save_model(args.output, model)
    print(f"[import] {hf_cfg.model_type} checkpoint -> {path}")
    return path


if __name__ == "__main__":
    main()
