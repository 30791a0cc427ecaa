"""Rotary position embeddings (port of llavamod_tpu/ops/rope.py).

Half-split ("rotate_half") layout matching HF Llama/Qwen2, partial rotary,
f32 tables applied in f32 with cast-back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_table(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
               rotary_dim: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] int -> (cos, sin) each [..., T, rotary_dim] in the
    HF duplicated layout [f0..f_{r/2-1}, f0..f_{r/2-1}]."""
    rdim = rotary_dim or head_dim
    exps = torch.arange(0, rdim, 2, dtype=torch.float32,
                        device=positions.device) / rdim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, r] or [T, r] with r <= Dh (partial
    rotary leaves the tail dims untouched)."""
    rdim = cos.shape[-1]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xr = x[..., :rdim].float()
    rotated = (xr * c + _rotate_half(xr) * s).to(x.dtype)
    if rdim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rdim:]], dim=-1)
