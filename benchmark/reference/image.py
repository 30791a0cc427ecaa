"""CLIP image preprocessing in plain NumPy: pad to a square with the mean
colour (LLaVA's `image_aspect_ratio="pad"`), resize the short side to the
tower's size with PIL's bicubic filter (a = -0.5, support widened by the
scale when shrinking, taps normalised, clipped to [0, 1] after each pass),
centre crop, normalise.  The resize is written as two dense matrices of
filter taps built and applied in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


def _taps(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] resampling matrix."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = int(max(0.0, math.floor(center - support)))
        hi = int(min(float(n_in), math.ceil(center + support)))
        x = np.arange(lo, hi)
        w = _cubic((x - center + 0.5) / fs)
        s = w.sum()
        m[o, lo:hi] = w / s if s != 0.0 else w
    return m


def preprocess(img: np.ndarray, size: int = 336, device="cpu") -> torch.Tensor:
    """uint8 [H, W, 3] -> float32 [3, size, size] on `device` (the taps'
    products in float64 there)."""
    h, w, _ = img.shape
    x = img.astype(np.float32) / 255.0
    if h != w:
        side = max(h, w)
        bg = np.array([int(v * 255) for v in CLIP_MEAN], np.float32) / 255.0
        sq = np.broadcast_to(bg, (side, side, 3)).copy()
        top, left = (side - h) // 2, (side - w) // 2
        sq[top:top + h, left:left + w] = x
        x, h, w = sq, side, side
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float64)

    x = f64(x).permute(2, 0, 1)                                # [c, h, w]
    tmp = (x @ f64(_taps(w, nw)).T).clamp(0.0, 1.0)            # [c, h, nw]
    out = f64(_taps(h, nh)) @ tmp                              # [c, nh, nw]
    top, left = (nh - size) // 2, (nw - size) // 2
    out = out[:, top:top + size, left:left + size].clamp(0.0, 1.0).float()
    mean = torch.tensor(CLIP_MEAN, device=device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=device)[:, None, None]
    return (out - mean) / std
