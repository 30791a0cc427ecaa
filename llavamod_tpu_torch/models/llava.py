"""LLaVA glue: vision tower + projector + decoder LLM (port of
llavamod_tpu/models/llava.py, image path).

The data pipeline pre-expands every '<image>' placeholder into
`num_image_tokens` reserved slots (llavamod_tpu/data/splice.py); the model
scatters image features into them with one static gather and select:

    emb = where(image_mask, image_features[image_pos], token_embeddings)

`Llava` holds {'vision', 'projector', 'llm'} so its state_dict keys are the
JAX paths ('vision.layers.0.attn.q.kernel', 'projector.layers.1.bias',
'llm.layers.3.attn.wq', ...).  A distillation teacher may be built without
its own tower (`vision=False`): it takes the student's frozen tower features
through `tower_feats`, as the JAX teacher tree drops its 'vision' copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.projector import Projector, build_projector
from llavamod_tpu_torch.models.vision import vit
from llavamod_tpu_torch.models.vision.vit import VisionConfig


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llm: DecoderConfig
    vision: VisionConfig
    projector_type: str = "mlp2x_gelu"
    select_layer: int = -2
    select_feature: str = "patch"
    image_aspect_ratio: str = "pad"
    max_images: int = 1                  # static per-sample image budget
    freeze_vision: bool = True
    s2_scales: Tuple[int, ...] = ()      # S2 multiscale: not ported yet
    video_projector_type: Optional[str] = None   # video: not ported yet
    video_global_proj: bool = False
    video_temporal_proj: bool = False
    video_spatial_proj: bool = False
    num_video_frames: int = 8

    @property
    def vision_feature_dim(self) -> int:
        mult = max(1, len(self.s2_scales))
        return self.vision.hidden_size * mult

    def build_projector(self) -> Projector:
        return build_projector(self.projector_type, self.vision_feature_dim,
                               self.llm.hidden_size)

    @property
    def num_image_tokens(self) -> int:
        return self.build_projector().num_output_tokens(self.vision.num_patches)

    def replace(self, **kw) -> "LlavaConfig":
        return dataclasses.replace(self, **kw)


class MultimodalBatch(NamedTuple):
    """Static-shape device batch (built on host by data/splice.py)."""
    input_ids: torch.Tensor    # [B, T] int32; image slots hold 0
    segment_ids: torch.Tensor  # [B, T] int32; 0 = padding
    image_mask: torch.Tensor   # [B, T] bool; True at image-feature slots
    image_pos: torch.Tensor    # [B, T] int32 index into flattened image rows
    pixels: torch.Tensor       # [B, M, 3, S, S]
    pixel_valid: torch.Tensor  # [B, M] bool
    labels: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None


class Llava(nn.Module):
    def __init__(self, cfg: LlavaConfig, *, generator: torch.Generator,
                 device=None, dtype=torch.float32, vision: bool = True):
        super().__init__()
        if cfg.s2_scales or cfg.video_projector_type is not None:
            raise NotImplementedError("S2 and the video projector are not "
                                      "ported yet")
        self.cfg = cfg
        if vision:
            self.vision = vit.init(cfg.vision, generator, device, dtype)
        self.projector = cfg.build_projector().init(generator, device, dtype)
        self.llm = decoder.init(cfg.llm, generator, device, dtype)

    def forward(self, batch: MultimodalBatch, **kw) -> "LlavaOutput":
        return forward(self, self.cfg, batch, **kw)


def init(cfg: LlavaConfig, generator: torch.Generator, device=None,
         dtype=torch.float32, vision: bool = True) -> Llava:
    return Llava(cfg, generator=generator, device=device, dtype=dtype,
                 vision=vision)


def encode_tower(model: Llava, cfg: LlavaConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, 3, S, S] -> frozen tower features [N, patches, D_vis]."""
    hidden = vit.forward(model.vision, cfg.vision, pixels, cfg.select_layer)
    feats = vit.select_features(cfg.vision, hidden, cfg.select_feature)
    return feats.detach() if cfg.freeze_vision else feats


def encode_images(model: Llava, cfg: LlavaConfig, pixels: torch.Tensor,
                  tower_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pixels [N, 3, S, S] -> projected features [N, tokens, D_llm]."""
    if tower_feats is None:
        tower_feats = encode_tower(model, cfg, pixels)
    return cfg.build_projector().apply(model.projector, tower_feats)


def multimodal_embed(model: Llava, cfg: LlavaConfig, batch: MultimodalBatch,
                     tower_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings with image features scattered into reserved slots."""
    b, t = batch.input_ids.shape
    emb = decoder.embed(model.llm, cfg.llm, batch.input_ids)
    pixels = batch.pixels.reshape((-1,) + tuple(batch.pixels.shape[2:]))
    feats = encode_images(model, cfg, pixels, tower_feats)   # [B*M, N, D]
    feats = torch.where(batch.pixel_valid.reshape(-1, 1, 1), feats, 0.0)
    flat = feats.reshape(-1, feats.shape[-1])
    gathered = flat[batch.image_pos.reshape(-1).long()]
    gathered = gathered.reshape(b, t, -1).to(emb.dtype)
    return torch.where(batch.image_mask[..., None], gathered, emb)


class LlavaOutput(NamedTuple):
    hidden: torch.Tensor
    aux_loss: torch.Tensor
    moe_losses: Tuple[torch.Tensor, ...]
    router_probs: Tuple[torch.Tensor, ...]
    cache: Optional[decoder.KVCache]


def forward(model: Llava, cfg: LlavaConfig, batch: MultimodalBatch, *,
            cache: Optional[decoder.KVCache] = None, train: bool = False,
            attn_impl: str = "auto", remat: bool = False,
            tower_feats: Optional[torch.Tensor] = None,
            prefix_mask: Optional[torch.Tensor] = None) -> LlavaOutput:
    emb = multimodal_embed(model, cfg, batch, tower_feats)
    out = decoder.forward(
        model.llm, cfg.llm, inputs_embeds=emb, positions=batch.positions,
        segment_ids=batch.segment_ids, cache=cache, train=train,
        attn_impl=attn_impl, remat=remat, prefix_mask=prefix_mask)
    return LlavaOutput(out.hidden, out.aux_loss, out.moe_losses,
                       out.router_probs, out.cache)


def logits(model: Llava, cfg: LlavaConfig, hidden: torch.Tensor) -> torch.Tensor:
    return decoder.logits_from_hidden(model.llm, cfg.llm, hidden)


def lm_head_weight(model: Llava, cfg: LlavaConfig) -> torch.Tensor:
    return decoder.lm_head_weight(model.llm, cfg.llm)
