"""The tolerance that holds a hand-written kernel to its plain version.

Both sides accumulate in f32 but round at different moments: the
probabilities go to bf16 before P.V against differently normalised running
maxima (online vs one-shot softmax), and the output is rounded to bf16.
The check is elementwise,

    |got - want| <= KERNEL_ATOL + KERNEL_RTOL * |want|,

an absolute term for entries near zero plus two bf16 roundings (2 x 2^-8,
rounded up to 8e-3) of the entry's own magnitude, so a large output entry
is not held to an absolute bound finer than its own ulp.
"""

from __future__ import annotations

import torch

KERNEL_ATOL = 2e-2
KERNEL_RTOL = 8e-3


def tol_ratio(got: torch.Tensor, want: torch.Tensor, *,
              atol: float = KERNEL_ATOL, rtol: float = KERNEL_RTOL) -> float:
    """max over the entries of |got - want| / (atol + rtol |want|), in f32:
    at most 1 where every entry is within the tolerance (0 for no entries)."""
    if got.shape != want.shape:
        raise ValueError(f"shapes {tuple(got.shape)} and {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    ratio = (g - w).abs() / (atol + rtol * w.abs())
    # a NaN anywhere fails the check rather than vanishing in max()
    return float("inf") if torch.isnan(ratio).any() else ratio.max().item()


def within_tol(got: torch.Tensor, want: torch.Tensor, **kw) -> bool:
    return tol_ratio(got, want, **kw) <= 1.0


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.numel() == 0:
        return 0.0
    return (got.float() - want.float()).abs().max().item()
