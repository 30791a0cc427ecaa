"""LLaVA glue: vision tower + projector + decoder LLM (port of
llavamod_tpu/models/llava.py), with the S2 multi-scale tower
(vision/s2.py) and the optional video projector (models/video.py).

The data pipeline pre-expands every '<image>' placeholder into
`num_image_tokens` reserved slots (llavamod_tpu/data/splice.py); the model
scatters image features into them with one static gather and select:

    emb = where(image_mask, image_features[image_pos], token_embeddings)

`Llava` holds {'vision', 'projector', 'llm'} so its state_dict keys are the
JAX paths ('vision.layers.0.attn.q.kernel', 'projector.layers.1.bias',
'llm.layers.3.attn.wq', ...).  A distillation teacher may be built without
its own tower (`vision=False`): it takes the student's frozen tower features
through `tower_feats`, as the JAX teacher tree drops its 'vision' copy.
With `video_projector_type` set the model also holds 'video_projector':
video frames run through the same frozen tower (CLS kept) and the video
projector, and their tokens follow the image rows in each sample's media
table, the layout data/splice.py indexes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.params import apply_through
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
    s2_scales: Tuple[int, ...] = ()      # e.g. (336, 672) enables S2
    # optional video projector bundle (reference multimodal_projector/
    # builder.py:125-205); None = off
    video_projector_type: Optional[str] = None
    video_global_proj: bool = False
    video_temporal_proj: bool = False
    video_spatial_proj: bool = False
    num_video_frames: int = 8            # static per-video frame budget

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

    def build_video_projector(self):
        """The video projector, at the width `encode_video` feeds it: the
        tower's hidden size, since frames run the tower without S2 (the
        reference's forward_video).  The JAX package sizes it at
        `vision_feature_dim`, which S2 multiplies, and fails at the first
        video batch."""
        from llavamod_tpu_torch.models.video import (
            VideoProjectorConfig,
            build_video_projector,
        )

        return build_video_projector(
            VideoProjectorConfig(projector_type=self.video_projector_type,
                                 global_proj=self.video_global_proj,
                                 temporal_proj=self.video_temporal_proj,
                                 spatial_proj=self.video_spatial_proj),
            self.vision.hidden_size, self.llm.hidden_size)

    @property
    def num_video_tokens(self) -> int:
        """Video-projector output tokens per video (0 when the path is off)."""
        if self.video_projector_type is None:
            return 0
        return self.build_video_projector().num_output_tokens(
            self.num_video_frames, self.vision.num_patches)

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
    # video-projector mode only (LlavaConfig.video_projector_type set):
    video_pixels: Optional[torch.Tensor] = None  # [B, F, 3, S, S]
    video_valid: Optional[torch.Tensor] = None   # [B] bool


class Llava(nn.Module):
    def __init__(self, cfg: LlavaConfig, *, generator: torch.Generator,
                 device=None, dtype=torch.float32, vision: bool = True):
        super().__init__()
        self.cfg = cfg
        if vision:
            self.vision = vit.init(cfg.vision, generator, device, dtype)
        self.projector = cfg.build_projector().init(generator, device, dtype)
        self.llm = decoder.init(cfg.llm, generator, device, dtype)
        if cfg.video_projector_type is not None:
            self.video_projector = cfg.build_video_projector().init(
                generator, device, dtype)

    def forward(self, batch: MultimodalBatch, cfg: "LlavaConfig | None" = None,
                **kw) -> "LlavaOutput":
        """`forward` through the module call (the training steps call the
        model this way, so that a sharded model gathers its parameters)."""
        return forward(self, cfg or self.cfg, batch, **kw)


def init(cfg: LlavaConfig, generator: torch.Generator, device=None,
         dtype=torch.float32, vision: bool = True) -> Llava:
    return Llava(cfg, generator=generator, device=device, dtype=dtype,
                 vision=vision)


def encode_tower(model: Llava, cfg: LlavaConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, 3, S, S] -> frozen tower features [N, patches, D_vis]
    (D_vis = hidden_size x len(s2_scales) under S2)."""
    if cfg.s2_scales:
        from llavamod_tpu_torch.models.vision.s2 import multiscale_forward

        feats = multiscale_forward(model.vision, cfg.vision, pixels,
                                   cfg.s2_scales, cfg.select_layer,
                                   cfg.select_feature)
    else:
        hidden = model.vision(pixels, cfg.select_layer, cfg.vision)
        feats = vit.select_features(cfg.vision, hidden, cfg.select_feature)
    return feats.detach() if cfg.freeze_vision else feats


def encode_images(model: Llava, cfg: LlavaConfig, pixels: torch.Tensor,
                  tower_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pixels [N, 3, S, S] -> projected features [N, tokens, D_llm]."""
    if tower_feats is None:
        tower_feats = encode_tower(model, cfg, pixels)
    return apply_through(model.projector, cfg.build_projector().apply,
                         tower_feats)


def multimodal_embed(model: Llava, cfg: LlavaConfig, batch: MultimodalBatch,
                     tower_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings with image features scattered into reserved slots."""
    b, t = batch.input_ids.shape
    emb = decoder.embed(model.llm, cfg.llm, batch.input_ids)
    pixels = batch.pixels.reshape((-1,) + tuple(batch.pixels.shape[2:]))
    feats = encode_images(model, cfg, pixels, tower_feats)   # [B*M, N, D]
    feats = torch.where(batch.pixel_valid.reshape(-1, 1, 1), feats, 0.0)
    if cfg.video_projector_type is not None and batch.video_pixels is not None:
        # per-sample media table = [image rows | video rows]
        feats = feats.reshape(batch.video_pixels.shape[0], -1, feats.shape[-1])
        vfeats = encode_video(model, cfg, batch.video_pixels,
                              batch.video_valid)
        feats = torch.cat([feats, vfeats.to(feats.dtype)], dim=1)
    flat = feats.reshape(-1, feats.shape[-1])
    gathered = flat[batch.image_pos.reshape(-1).long()]
    gathered = gathered.reshape(b, t, -1).to(emb.dtype)
    return torch.where(batch.image_mask[..., None], gathered, emb)


def encode_video(model: Llava, cfg: LlavaConfig, video_pixels: torch.Tensor,
                 video_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, F, 3, S, S] frames -> [B, num_video_tokens, D] through the frozen
    tower (per frame, CLS kept, no S2) and the video projector."""
    b, f = video_pixels.shape[:2]
    px = video_pixels.reshape((-1,) + tuple(video_pixels.shape[2:]))
    hidden = model.vision(px, cfg.select_layer, cfg.vision)
    feats = vit.select_features(cfg.vision, hidden, "cls_patch")
    if cfg.freeze_vision:
        feats = feats.detach()
    if not cfg.vision.use_class_token:
        # the projector splits [CLS | patches]: a tower without a class
        # token gets a zero CLS row
        feats = torch.cat([torch.zeros_like(feats[:, :1]), feats], dim=1)
    feats = feats.reshape(b, f, feats.shape[-2], feats.shape[-1])
    out = cfg.build_video_projector().apply(model.video_projector, feats)
    if video_valid is not None:
        out = torch.where(video_valid.reshape(-1, 1, 1), out, 0.0)
    return out


class LlavaOutput(NamedTuple):
    hidden: torch.Tensor
    aux_loss: torch.Tensor
    moe_losses: Tuple[torch.Tensor, ...]
    router_probs: Tuple[torch.Tensor, ...]
    cache: Optional[decoder.KVCache]
    tower_feats: Optional[torch.Tensor] = None   # the frozen tower's output


def forward(model: Llava, cfg: LlavaConfig, batch: MultimodalBatch, *,
            cache: Optional[decoder.KVCache] = None, train: bool = False,
            attn_impl: str = "auto", remat: bool = False,
            tower_feats: Optional[torch.Tensor] = None,
            prefix_mask: Optional[torch.Tensor] = None) -> LlavaOutput:
    if tower_feats is None:
        tower_feats = encode_tower(model, cfg, batch.pixels.reshape(
            (-1,) + tuple(batch.pixels.shape[2:])))
    emb = multimodal_embed(model, cfg, batch, tower_feats)
    out = decoder.forward(
        model.llm, cfg.llm, inputs_embeds=emb, positions=batch.positions,
        segment_ids=batch.segment_ids, cache=cache, train=train,
        attn_impl=attn_impl, remat=remat, prefix_mask=prefix_mask)
    return LlavaOutput(out.hidden, out.aux_loss, out.moe_losses,
                       out.router_probs, out.cache, tower_feats)


@torch.no_grad()
def initialize_vision_tokenizer(model: Llava, cfg: LlavaConfig, tokenizer, *,
                                mm_use_im_patch_token: bool = False,
                                mm_use_im_start_end: bool = False,
                                pretrain_mm_mlp_adapter: Optional[str] = None):
    """Add the image special tokens to `tokenizer` and grow the vocabulary
    of `model` in place (the reference's model/llava_arch.py:336-379, the
    JAX package's function of the same name): the embedding and an untied
    head gain one row per token the tokenizer did not have, each the mean
    of the existing rows (taken in float64); with `mm_use_im_start_end` a
    stage-1 mm_projector.bin holding 'model.embed_tokens.weight' donates
    the new embedding rows.  Returns (cfg, model) with the grown
    vocabulary."""
    from llavamod_tpu_torch.constants import (
        DEFAULT_IM_END_TOKEN,
        DEFAULT_IM_START_TOKEN,
        DEFAULT_IMAGE_PATCH_TOKEN,
    )

    new_tokens = []
    if mm_use_im_patch_token:
        new_tokens.append(DEFAULT_IMAGE_PATCH_TOKEN)
    if mm_use_im_start_end:
        new_tokens += [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN]
    if not new_tokens:
        return cfg, model
    num_new = tokenizer.add_tokens(new_tokens, special_tokens=True)
    if num_new <= 0:
        return cfg, model

    def grow(group, name):
        # the mean in float64, rounded once: the same bits on every device
        # (the JAX package's f32 mean follows XLA's reduction order)
        w = getattr(group, name)
        mean = w.double().mean(dim=0, keepdim=True).expand(num_new,
                                                           *w.shape[1:])
        setattr(group, name, nn.Parameter(torch.cat([w, mean.to(w.dtype)]),
                                          requires_grad=w.requires_grad))

    llm = model.llm
    grow(llm.embed, "embedding")
    if hasattr(llm, "lm_head"):
        grow(llm.lm_head, "weight")
        if hasattr(llm.lm_head, "bias"):
            grow(llm.lm_head, "bias")
    cfg = cfg.replace(llm=cfg.llm.replace(
        vocab_size=cfg.llm.vocab_size + num_new))
    model.cfg, llm.cfg = cfg, cfg.llm

    if mm_use_im_start_end and pretrain_mm_mlp_adapter:
        state = torch.load(pretrain_mm_mlp_adapter, map_location="cpu",
                           weights_only=True)
        if "model.embed_tokens.weight" in state:
            w = state["model.embed_tokens.weight"]
            e = llm.embed.embedding
            if num_new != 2:
                raise ValueError(f"the donor rows of {pretrain_mm_mlp_adapter} "
                                 f"are for 2 new tokens, not {num_new}")
            if tuple(w.shape) == tuple(e.shape):
                w = w[-num_new:]
            elif w.shape[0] != num_new:
                raise ValueError(
                    f"Unexpected embed_tokens_weight shape {tuple(w.shape)} "
                    f"vs {tuple(e.shape)} with {num_new} new tokens")
            e[-num_new:] = w.to(e.dtype)
    return cfg, model


def logits(model: Llava, cfg: LlavaConfig, hidden: torch.Tensor) -> torch.Tensor:
    return decoder.logits_from_hidden(model.llm, cfg.llm, hidden)


def lm_head_weight(model: Llava, cfg: LlavaConfig) -> torch.Tensor:
    return decoder.lm_head_weight(model.llm, cfg.llm)
