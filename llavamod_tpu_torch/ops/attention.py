"""Attention ops (port of llavamod_tpu/ops/attention.py).

`dot_product_attention` is the single entry point.  Two implementations:

  * 'xla'   — `xla_attention`, the plain PyTorch version: einsum + f32
              softmax, GQA by logical head grouping (reshape, never a K/V
              repeat).  The name is kept from the JAX package.
  * 'flash' — the hand-written Hopper kernels (ops/flash_attention.py):
              K1 forward, and when a gradient is asked for, the autograd
              Function whose backward is K3 + K4.

'auto' sends a CUDA tensor with no dense mask or bias to the kernel and a
CPU tensor to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite "-inf" that keeps softmax numerics safe in bf16/fp32


def make_causal_mask(t: int, s: int, device=None) -> torch.Tensor:
    """[t, s] lower-triangular bool mask aligned to the *end*
    (decode-friendly): query i attends to kv j iff j - (s - t) <= i."""
    qi = torch.arange(t, device=device)[:, None] + (s - t)
    kj = torch.arange(s, device=device)[None, :]
    return kj <= qi


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    kv_layout: str = "bskd",
) -> torch.Tensor:
    """Plain attention.  q:[B,T,H,D] k,v:[B,S,KH,D] -> [B,T,H,D].

    mask: broadcastable to [B, 1|H, T, S], True = attend.
    bias: broadcastable additive bias (same shape rules).
    kv_layout: 'bskd' (default) or 'bksd' (the head-major KV-cache layout).
    """
    b, t, h, d = q.shape
    if kv_layout == "bskd":
        s, kh = k.shape[1], k.shape[2]
    else:
        kh, s = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale

    qg = q.reshape(b, t, kh, h // kh, d)
    logits = torch.einsum(f"btkgd,{kv_layout}->bkgts", qg.float(),
                          k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.reshape(b, h, t, s)

    if bias is not None:
        logits = logits + bias.float()
    if causal:
        cm = make_causal_mask(t, s, device=q.device)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    pg = probs.reshape(b, kh, h // kh, t, s)
    out = torch.einsum(f"bkgts,{kv_layout}->btkgd", pg, v.to(q.dtype))
    return out.reshape(b, t, h, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    segment_ids: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    impl: str = "auto",
    kv_layout: str = "bskd",
) -> torch.Tensor:
    """Dispatching attention entry point.

    segment_ids: (q_seg [B,T], kv_seg [B,S]) — tokens attend only within equal
    nonzero segment ids (0 = padding).  Composes with `causal`.
    kv_layout: 'bskd' | 'bksd' (xla impl only; flash requires 'bskd').
    """
    if impl == "auto":
        impl = ("flash" if q.is_cuda and bias is None and mask is None
                else "xla")

    if impl == "flash":
        if kv_layout != "bskd":
            raise ValueError("flash kernel takes [B,S,KH,D] K/V")
        from llavamod_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, segment_ids=segment_ids,
                               causal=causal, scale=scale, softcap=softcap)

    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        seg_mask = ((q_seg[:, None, :, None] == kv_seg[:, None, None, :])
                    & (kv_seg[:, None, None, :] != 0))
        mask = seg_mask if mask is None else (mask & seg_mask)
    return xla_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                         scale=scale, softcap=softcap, kv_layout=kv_layout)
