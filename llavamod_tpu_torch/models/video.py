"""Video projector: per-frame tower features -> LLM embedding tokens (port
of llavamod_tpu/models/video.py; reference multimodal_projector/
builder.py:69-198).

Each frame's tower output is split into its CLS vector and its patch
vectors; the patches go through any registry projector, and up to three
Linear-GELU-Linear summaries are added: global (the CLS vector, before the
frame's patch tokens), temporal (the frame's patch mean, after them) and
spatial (the patch mean across frames, appended after the last frame).
Every sample carries the same frame count, so the assembly is one
concatenation into a dense [B, tokens, D]; token order as the reference:

    frame j:        [global?] [patch tokens (new_n)] [temporal?]
    after frame T-1: [spatial? (n)]

The module's state-dict keys are the JAX tree's: 'patch.*', and
'global.layers.*', 'temporal.layers.*', 'spatial.layers.*' where on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from llavamod_tpu_torch.models.projector import (
    _mlp_apply,
    _mlp_init,
    build_projector,
)


@dataclasses.dataclass(frozen=True)
class VideoProjectorConfig:
    """The reference's video model args (config/args.py:27-30)."""
    projector_type: str = "linear"   # any registry spec
    global_proj: bool = False        # CLS summary token per frame
    temporal_proj: bool = False      # patch-mean summary token per frame
    spatial_proj: bool = False       # across-frame patch mean, last frame


class VideoProjector(NamedTuple):
    cfg: VideoProjectorConfig
    init: Callable[..., nn.Module]    # (generator, device, dtype) -> module
    apply: Callable                   # (module, feats [B,T,1+N,C]) -> [B,S,D]
    num_output_tokens: Callable[[int, int], int]  # (frames, patches) -> S


def build_video_projector(cfg: VideoProjectorConfig, vision_dim: int,
                          llm_dim: int) -> VideoProjector:
    patch = build_projector(cfg.projector_type, vision_dim, llm_dim)
    summaries = [name for name, on in (("global", cfg.global_proj),
                                       ("temporal", cfg.temporal_proj),
                                       ("spatial", cfg.spatial_proj)) if on]
    summary = _mlp_init(vision_dim, llm_dim, 2)

    def init(generator, device=None, dtype=torch.float32) -> nn.Module:
        m = nn.Module()
        m.patch = patch.init(generator, device, dtype)
        for name in summaries:     # 'global' is a keyword: add_module
            m.add_module(name, summary(generator, device, dtype))
        return m

    def apply(p: nn.Module, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, T, 1+N, C] (CLS + patches per frame) -> [B, S, D]."""
        b, t, n1, c = feats.shape
        cls, patches = feats[:, :, 0, :], feats[:, :, 1:, :]
        proj = patch.apply(p.patch, patches.reshape(b * t, n1 - 1, c))
        new_n, d = proj.shape[-2:]
        blocks = [proj.reshape(b, t, new_n, d)]
        if cfg.temporal_proj:
            blocks.append(_mlp_apply(p.temporal, patches.mean(dim=2))[:, :, None])
        if cfg.global_proj:
            blocks.insert(0, _mlp_apply(getattr(p, "global"), cls)[:, :, None])
        frames = torch.cat(blocks, dim=2) if len(blocks) > 1 else blocks[0]
        out = frames.reshape(b, t * frames.shape[2], d)
        if cfg.spatial_proj:
            tail = _mlp_apply(p.spatial, patches.mean(dim=1))
            out = torch.cat([out, tail], dim=1)        # [B, S + n, D]
        return out

    def num_output_tokens(frames: int, patches: int) -> int:
        per_frame = (patch.num_output_tokens(patches)
                     + int(cfg.global_proj) + int(cfg.temporal_proj))
        return frames * per_frame + (patches if cfg.spatial_proj else 0)

    return VideoProjector(cfg, init, apply, num_output_tokens)
