"""Model save/load for the port (counterpart of llavamod_tpu/models/builder.py).

Two formats:
  * native — a directory with `llavamod_config.json` (the LlavaConfig as
    JSON, the same file the JAX package writes) and `model.pt`, the flat
    state dict saved with torch.save and loaded with weights_only=True;
  * HF import — a directory with an HF `config.json` and the weights in
    `*.safetensors` (sharded or not) or `pytorch_model*.bin`, converted
    through interop/hf.py (`import_hf_llava`).  The files are
    memory-mapped and each tensor is transposed on its way to the device,
    in the file's dtype: no f32 copy of the checkpoint is made on the host.

`load_pretrained_model(path)` returns (tokenizer, model, cfg,
image_preprocessor, context_len) like the reference API; with `model_base`
the path is a PEFT adapter directory, merged onto the base model read from
`model_base` (models/lora.py).  `quantize_for_serving` turns a loaded model
into its int8 W8A8 serving form.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from llavamod_tpu_torch.interop.safetensors_io import read_safetensors
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


def save_model(output_dir: str, model: Llava,
               state: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """llavamod_config.json + model.pt of `model` (its `state`, when given:
    the whole state dict gathered from a sharded model)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, CONFIG_NAME), "w") as f:
        json.dump(config_to_dict(model.cfg), f, indent=2)
    state = {k: v.detach().cpu() for k, v in
             (model.state_dict() if state is None else state).items()}
    torch.save(state, os.path.join(output_dir, WEIGHTS_NAME))
    return output_dir


GROUPS = ("vision", "projector", "llm")


def from_state(cfg: LlavaConfig, state: dict, source: str, device, dtype,
               fill_missing_seed: Optional[int], drop_missing: bool = False
               ) -> Llava:
    """The Llava of `cfg` on `device`, in `dtype` if given (else the dtype of
    the embedding in `state`), holding the flat `state`.  Groups ('vision',
    'projector', 'llm') that `state` lacks entirely are initialized fresh
    from `fill_missing_seed`, directly on `device`; without a seed they
    make loading fail, or with `drop_missing` are left off the model for
    the caller to judge.  `state` may also lack what an HF modeling does
    not have: LayerNorm biases (MPT) and an untied head (then the embedding
    serves as the head, as in the JAX tree)."""
    dt = dtype or state.get("llm.embed.embedding",
                            next(iter(state.values()))).dtype
    groups = GROUPS + (("video_projector",) if cfg.video_projector_type
                       else ())
    missing = [g for g in groups
               if not any(k.startswith(g + ".") for k in state)]
    if missing and fill_missing_seed is None and not drop_missing:
        raise KeyError(f"{source} holds no {missing} weights")
    # build on the meta device (no init cost), then adopt the loaded tensors
    model = llava.init(cfg, None, device="meta", dtype=dt)
    keys = model.load_state_dict(state, strict=False, assign=True)
    absent = [k for k in keys.missing_keys if k.split(".")[0] not in missing]
    if any(k.startswith("llm.lm_head.") for k in absent):
        del model.llm.lm_head
    for k in absent:
        if k.endswith("norm.bias"):
            delattr(model.get_submodule(k.rsplit(".", 1)[0]), "bias")
    absent = [k for k in absent if not k.startswith("llm.lm_head.")
              and not k.endswith("norm.bias")]
    if keys.unexpected_keys or absent:
        raise KeyError(f"{source}: unexpected {keys.unexpected_keys[:4]}, "
                       f"missing {absent[:4]}")
    if missing and fill_missing_seed is not None:
        gen = torch.Generator(device=device).manual_seed(fill_missing_seed)
        build = {"vision": lambda: vit.init(cfg.vision, gen, device, dt),
                 "projector": lambda: cfg.build_projector().init(gen, device,
                                                                 dt),
                 "llm": lambda: decoder.init(cfg.llm, gen, device, dt),
                 "video_projector": lambda: cfg.build_video_projector().init(
                     gen, device, dt)}
        for g in missing:
            setattr(model, g, build[g]())
    else:
        for g in missing:
            delattr(model, g)
    return model.to(device=device, dtype=dt)


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
    return cfg, from_state(cfg, state, model_dir, device, dtype,
                       fill_missing_seed)


# ---------------------------------------------------------------------------
# HF import
# ---------------------------------------------------------------------------

def _load_torch_state(model_path: str) -> dict:
    """All weights of an HF checkpoint directory, memory-mapped on the host
    in the file's dtypes: every `*.safetensors` file (the shards that
    `model.safetensors.index.json` names, when it is there), else every
    `*.bin` but optimizer states, as the JAX builder chooses."""
    names = sorted(os.listdir(model_path))
    st_files = [n for n in names if n.endswith(".safetensors")]
    bin_files = [n for n in names if n.endswith(".bin")
                 and "optimizer" not in n]
    state = {}
    if st_files:
        index = os.path.join(model_path, "model.safetensors.index.json")
        weight_map = {}
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            st_files = sorted(set(weight_map.values()))
        for fname in st_files:
            state.update(read_safetensors(os.path.join(model_path, fname)))
        lost = sorted(set(weight_map) - set(state))
        if lost:
            raise KeyError(f"{model_path}: the index names {lost[:4]}, which "
                           f"no shard holds")
    elif bin_files:
        for fname in bin_files:
            state.update(torch.load(os.path.join(model_path, fname),
                                    map_location="cpu", weights_only=True,
                                    mmap=True))
    else:
        raise FileNotFoundError(f"no weights found in {model_path}")
    return state


def import_hf_llava(model_path: str, vision_path: Optional[str] = None,
                    projector_type: str = "mlp2x_gelu",
                    image_aspect_ratio: str = "pad", select_layer: int = -2,
                    device="cuda", dtype=None,
                    fill_missing_seed: Optional[int] = None
                    ) -> Tuple[LlavaConfig, Llava]:
    """Import an HF-format LLaVA-style (or text-only LLM) checkpoint
    directory onto `device`, in the file's dtype unless `dtype` is given.
    The config's `mm_*` fields win over the arguments, as in the JAX
    builder.  The tower comes from `vision_path` (an HF CLIP or SigLIP
    directory) when given: an HF LLaVA directory holds none.  Groups the
    checkpoints lack are initialized from `fill_missing_seed`, or else left
    off the model."""
    from llavamod_tpu_torch.interop import hf

    hf_cfg = hf.load_hf_config(model_path)
    llm_cfg = hf.decoder_config_from_hf(hf_cfg)
    tower_name = vision_path or getattr(
        hf_cfg, "mm_image_tower", getattr(hf_cfg, "mm_vision_tower",
                                          "clip-vit-l-336"))
    vis_cfg = vit.vision_configs.get(
        vit.vision_configs.match_substring(tower_name) or "clip-vit-l-336")
    cfg = LlavaConfig(
        llm=llm_cfg, vision=vis_cfg,
        projector_type=getattr(hf_cfg, "mm_projector_type", projector_type),
        select_layer=getattr(hf_cfg, "mm_vision_select_layer", select_layer),
        image_aspect_ratio=getattr(hf_cfg, "image_aspect_ratio",
                                   image_aspect_ratio))

    state = _load_torch_state(model_path)
    out = hf.prefixed("llm", hf.decoder_params_from_hf(
        state, llm_cfg, device=device, dtype=dtype))
    proj = {k: v for k, v in state.items() if "mm_projector" in k}
    if proj:
        out.update(hf.prefixed("projector", hf.projector_params_from_hf(
            proj, cfg.projector_type, device=device, dtype=dtype)))
    del state, proj
    if vision_path and os.path.isdir(vision_path):
        out.update(hf.prefixed("vision", hf.vision_params_from_hf(
            _load_torch_state(vision_path), vis_cfg, device=device,
            dtype=dtype)))
    return cfg, from_state(cfg, out, model_path, device, dtype,
                           fill_missing_seed, drop_missing=True)


def make_image_preprocessor(cfg: LlavaConfig) -> ImagePreprocessor:
    siglip = not cfg.vision.use_class_token
    return ImagePreprocessor(
        size=cfg.vision.image_size,
        mean=SIGLIP_IMAGE_MEAN if siglip else CLIP_IMAGE_MEAN,
        std=SIGLIP_IMAGE_STD if siglip else CLIP_IMAGE_STD,
        image_aspect_ratio=cfg.image_aspect_ratio)


def load_any(path: str, device="cuda", dtype=None,
             vision_path: Optional[str] = None, complete: bool = True
             ) -> Tuple[LlavaConfig, Llava]:
    """A native checkpoint directory (`load_model`) or an HF one
    (`import_hf_llava`, its tower from `vision_path`).  With `complete`, an
    HF model without one of the groups raises, naming `vision_path` for a
    missing tower; the checkpoint tools take it as it is."""
    if os.path.exists(os.path.join(path, CONFIG_NAME)):
        return load_model(path, device=device, dtype=dtype)
    cfg, model = import_hf_llava(path, vision_path=vision_path,
                                 device=device, dtype=dtype)
    missing = [g for g in GROUPS if not hasattr(model, g)]
    if missing and complete:
        hint = (" (an HF LLaVA directory holds no vision tower: pass "
                "vision_path, an HF CLIP or SigLIP directory)"
                if "vision" in missing else "")
        raise ValueError(f"{path} holds no {missing} weights{hint}")
    return cfg, model


def load_pretrained_model(model_path: str, model_base: Optional[str] = None,
                          device="cuda", dtype=None, tokenizer_path=None,
                          context_len: int = 2048, tokenizer=None,
                          vision_path: Optional[str] = None):
    """Reference-shaped loader: returns (tokenizer, model, cfg,
    image_preprocessor, context_len) for a native checkpoint directory or
    an HF one (`import_hf_llava`; its tower from `vision_path`, an HF CLIP
    or SigLIP directory, since an HF LLaVA directory holds none).

    With `model_base`, `model_path` is a LoRA adapter directory (PEFT's
    adapter_config.json + adapter_model.bin, and non_lora_trainables.bin
    when the trainer saved one): the base's config and weights come from
    `model_base`, native or HF, and the adapters are merged into them, as
    the reference's builder (model/builder.py:82-155) and tools/merge_lora
    read them.  (The JAX loader reads the base from the adapter directory
    instead and fails there.)

    The tokenizer is `tokenizer` when given, else the tiktoken vocabulary
    (qwen-1.0, arcade100k) or the HF tokenizer files in `tokenizer_path` or
    the checkpoint directory (the base's under `model_base`, as the
    reference); transformers is imported only then."""
    if model_base is not None:
        from llavamod_tpu_torch.models.lora import merge_lora_checkpoint

        cfg, model = merge_lora_checkpoint(
            model_path, *load_any(model_base, device, dtype, vision_path))
    else:
        cfg, model = load_any(model_path, device, dtype, vision_path)
    if tokenizer is None:
        from llavamod_tpu_torch.interop.tiktoken_tokenizers import (
            load_tiktoken_tokenizer,
        )

        tok_path = tokenizer_path or model_base or model_path
        # qwen-1.0 / stablelm checkpoints carry a *.tiktoken vocab
        tokenizer = load_tiktoken_tokenizer(tok_path)
        if tokenizer is None:
            import transformers

            tokenizer = transformers.AutoTokenizer.from_pretrained(tok_path)
    return tokenizer, model, cfg, make_image_preprocessor(cfg), context_len


def quantize_for_serving(model: Llava) -> Llava:
    """int8 W8A8 serving of a loaded model, in place: attention and MLP,
    the MoE experts, the LM head and the embedding table all int8 (the JAX
    builder's `quantize_for_serving`; the reference's load_8bit
    counterpart)."""
    decoder.quantize_decoder_int8(model.llm, include_lm_head=True,
                                  include_experts=True, include_embed=True)
    return model
