"""Scaling-on-Scales (S2) multi-scale vision features (port of
llavamod_tpu/models/vision/s2.py; reference CLIPVisionTowerS2,
clips2_encoder.py:8-67, which delegates to the `s2wrapper` package).

For each scale: resize the image, split it into base-size tiles, encode
every tile with the shared tower, reassemble the tile feature grids into
one large grid, average-pool it back to the base grid; then concatenate the
scales' channels, so the feature width is hidden_size * len(scales).

The resize is `jax.image.resize(..., "bicubic")` exactly: Keys' cubic
kernel with a = -0.5, the weights of each output sample renormalised to
sum to 1 (which is what changes them near the edges), samples outside the
input zeroed, the kernel widened by the scale when shrinking (antialias).
`torch.nn.functional.interpolate(mode="bicubic")` is another function
(a = -0.75, clamped edge indices), so `resize_weights` builds the per-axis
[in, out] matrices as `jax.image.scale_and_translate` does and the resize
is two matmuls, in the image's dtype as the JAX einsum runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from llavamod_tpu_torch.models.vision import vit
from llavamod_tpu_torch.models.vision.vit import VisionConfig, VisionTower


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, device=None,
                   antialias: bool = True) -> torch.Tensor:
    """[in_size, out_size] f32 bicubic weights of one axis (translation 0,
    scale out/in), as jax.image's `compute_weight_mat`."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bicubic(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, size, size] (jax.image.resize bicubic)."""
    h, w = pixels.shape[-2:]
    out = pixels
    if h != size:
        wh = resize_weights(h, size, pixels.device).to(pixels.dtype)
        out = torch.matmul(wh.t(), out)                 # [B, C, size, W]
    if w != size:
        ww = resize_weights(w, size, pixels.device).to(pixels.dtype)
        out = torch.matmul(out, ww)                     # [B, C, size, size]
    return out


def multiscale_forward(tower: VisionTower, cfg: VisionConfig,
                       pixels: torch.Tensor, scales: Sequence[int],
                       select_layer: int = -2,
                       select_feature: str = "patch") -> torch.Tensor:
    """pixels [B, 3, S0, S0] -> [B, num_patches, hidden * len(scales)]."""
    base, g = cfg.image_size, cfg.grid
    b = pixels.shape[0]
    outs = []
    for scale in scales:
        x = pixels if scale == base else resize_bicubic(pixels, scale)
        n = scale // base
        if n == 1:
            outs.append(vit.select_features(
                cfg, tower(x, select_layer, cfg), select_feature))
            continue
        # tiles: [B, 3, n, base, n, base] -> [B*n*n, 3, base, base]
        tiles = x.reshape(b, 3, n, base, n, base).permute(0, 2, 4, 1, 3, 5)
        tiles = tiles.reshape(b * n * n, 3, base, base)
        feats = vit.select_features(
            cfg, tower(tiles, select_layer, cfg), select_feature)
        d = feats.shape[-1]
        # reassemble the full feature grid, then average-pool to the base grid
        grid = feats.reshape(b, n, n, g, g, d).permute(0, 1, 3, 2, 4, 5)
        grid = grid.reshape(b, n * g, n * g, d)
        pooled = grid.reshape(b, g, n, g, n, d).mean(dim=(2, 4))
        outs.append(pooled.reshape(b, g * g, d))
    return torch.cat(outs, dim=-1)
