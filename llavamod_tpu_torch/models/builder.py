"""Model save/load for the port (counterpart of llavamod_tpu/models/builder.py).

A native checkpoint directory holds `llavamod_config.json` (the LlavaConfig
as JSON, the same file the JAX package writes) and `model.pt`, the flat
state dict saved with torch.save and loaded with weights_only=True.
`quantize_for_serving` turns a loaded model into its int8 W8A8 serving form.
HF checkpoint import is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from llavamod_tpu_torch.mm_utils import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    SIGLIP_IMAGE_MEAN,
    SIGLIP_IMAGE_STD,
    ImagePreprocessor,
)
from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llava import Llava, LlavaConfig
from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.vision import vit
from llavamod_tpu_torch.models.vision.vit import VisionConfig

CONFIG_NAME = "llavamod_config.json"
WEIGHTS_NAME = "model.pt"


def config_to_dict(cfg: LlavaConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> LlavaConfig:
    llm = DecoderConfig(**{k: tuple(v) if k in ("moe_layers",) else v
                           for k, v in d["llm"].items()})
    vision = VisionConfig(**d["vision"])
    rest = {k: v for k, v in d.items() if k not in ("llm", "vision")}
    if "s2_scales" in rest:
        rest["s2_scales"] = tuple(rest["s2_scales"])
    return LlavaConfig(llm=llm, vision=vision, **rest)


def save_model(output_dir: str, model: Llava) -> str:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, CONFIG_NAME), "w") as f:
        json.dump(config_to_dict(model.cfg), f, indent=2)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(output_dir, WEIGHTS_NAME))
    return output_dir


GROUPS = ("vision", "projector", "llm")


def load_model(model_dir: str, device="cuda", dtype=None,
               fill_missing_seed: Optional[int] = None
               ) -> Tuple[LlavaConfig, Llava]:
    """Returns (cfg, model) with the weights on `device` (the card unless
    the caller asks for another), in `dtype` if given (else in the stored
    dtype).  A checkpoint may lack whole groups ('vision', 'projector',
    'llm'; a distillation teacher is often saved without its tower): with
    `fill_missing_seed` they are initialized fresh from that seed, directly
    on `device` and in the stored dtype, else loading fails."""
    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        cfg = config_from_dict(json.load(f))
    # off the CPU the file is memory-mapped: each tensor is read once, on
    # its way to the device
    state = torch.load(os.path.join(model_dir, WEIGHTS_NAME),
                       map_location="cpu", weights_only=True,
                       mmap=torch.device(device).type != "cpu")
    dt = dtype or next(iter(state.values())).dtype
    missing = [g for g in GROUPS
               if not any(k.startswith(g + ".") for k in state)]
    if missing and fill_missing_seed is None:
        raise KeyError(f"{model_dir} holds no {missing} weights")
    # build on the meta device (no init cost), then adopt the loaded tensors
    model = llava.init(cfg, None, device="meta", dtype=dt)
    keys = model.load_state_dict(state, strict=False, assign=True)
    if keys.unexpected_keys or any(k.split(".")[0] not in missing
                                   for k in keys.missing_keys):
        raise KeyError(f"{model_dir}: unexpected {keys.unexpected_keys[:4]}, "
                       f"missing {keys.missing_keys[:4]}")
    fresh = {}
    if missing:
        gen = torch.Generator(device=device).manual_seed(fill_missing_seed)
        build = {"vision": lambda: vit.init(cfg.vision, gen, device, dt),
                 "projector": lambda: cfg.build_projector().init(gen, device,
                                                                 dt),
                 "llm": lambda: decoder.init(cfg.llm, gen, device, dt)}
        fresh = {g: build[g]() for g in missing}
    for g, module in fresh.items():
        setattr(model, g, module)
    model = model.to(device=device, dtype=dt)
    return cfg, model


def make_image_preprocessor(cfg: LlavaConfig) -> ImagePreprocessor:
    siglip = not cfg.vision.use_class_token
    return ImagePreprocessor(
        size=cfg.vision.image_size,
        mean=SIGLIP_IMAGE_MEAN if siglip else CLIP_IMAGE_MEAN,
        std=SIGLIP_IMAGE_STD if siglip else CLIP_IMAGE_STD,
        image_aspect_ratio=cfg.image_aspect_ratio)


def load_pretrained_model(model_path: str, device="cuda", dtype=None,
                          tokenizer_path=None, context_len: int = 2048):
    """Reference-shaped loader: returns (tokenizer, model, cfg,
    image_preprocessor, context_len) for a native checkpoint directory that
    carries its own HF tokenizer files."""
    cfg, model = load_model(model_path, device=device, dtype=dtype)
    import transformers  # the tokenizer is the only user of transformers

    tokenizer = transformers.AutoTokenizer.from_pretrained(
        tokenizer_path or model_path)
    return tokenizer, model, cfg, make_image_preprocessor(cfg), context_len


def quantize_for_serving(model: Llava) -> Llava:
    """int8 W8A8 serving of a loaded model, in place: attention and MLP,
    the MoE experts, the LM head and the embedding table all int8 (the JAX
    builder's `quantize_for_serving`; the reference's load_8bit
    counterpart)."""
    decoder.quantize_decoder_int8(model.llm, include_lm_head=True,
                                  include_experts=True, include_embed=True)
    return model
