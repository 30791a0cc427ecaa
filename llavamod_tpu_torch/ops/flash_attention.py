"""Flash attention: forward kernel K1 (csrc/flash_fwd.cu), backward kernels
K3 (csrc/flash_dq.cu) and K4 (csrc/flash_dkv.cu), and their plain PyTorch
versions.

Port of llavamod_tpu/ops/flash_attention.py.  The layout at the API is
[B, T, H, D] for q and [B, S, KH, D] for k/v, as in the JAX package; the
kernels read it through strides, so no transpose copy is made.  Varlen
batches are expressed with segment ids (0 = padding).  Causal masking is
aligned at the start (column <= row), as in the JAX flash kernel.

  * `flash_fwd` — K1's wrapper.  A CUDA tensor launches K1 (bf16, D in
    {64, 128}) or raises; a CPU tensor goes to `flash_fwd_reference`.
  * `flash_dq` / `flash_dkv` — the wrappers of K3 (dq) and K4 (dk, dv),
    with the same rule and the plain versions `flash_dq_reference` /
    `flash_dkv_reference`; `flash_bwd` computes delta = rowsum(dO * O) and
    calls both (plain: `flash_bwd_reference`).
  * `flash_attention` — the public function of the JAX package.  When a
    gradient is asked for it runs `FlashAttention`, the autograd Function
    whose forward is K1 (saving q, k, v, segments, o and lse) and whose
    backward is K3 + K4, as the JAX `_flash` custom_vjp.

Each wrapper counts its kernel launches in `<wrapper>.launches`.  The
plain versions keep the kernels' rounding points: probabilities are cast to
the value dtype before P.V and dO-products, ds to the operand dtype before
ds.K and ds^T.Q; fully masked rows give output 0, lse NEG_INF and zero
gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_SegIds = Optional[Tuple[torch.Tensor, torch.Tensor]]


def live_pairs(q_seg, kv_seg, t: int, s: int, causal: bool,
               device) -> torch.Tensor:
    """[B or 1, T, S] bool: the (query, key) pairs that attend, the same
    nonzero segment and, if causal, key <= query."""
    mask = torch.ones((1, t, s), dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(t, device=device)[:, None]
        cols = torch.arange(s, device=device)[None, :]
        mask = mask & (cols <= rows)
    if q_seg is not None:
        mask = mask & ((q_seg[:, :, None] == kv_seg[:, None, :])
                       & (kv_seg[:, None, :] != 0))
    return mask


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_seg: Optional[torch.Tensor] = None,
                        kv_seg: Optional[torch.Tensor] = None, *,
                        causal: bool = False, scale: Optional[float] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1.  q [B,T,H,D]; k, v [B,S,KH,D]; q_seg [B,T] and
    kv_seg [B,S] int (0 = pad) or both None.  Returns (o [B,T,H,D] in
    q.dtype, lse [B,H,T] f32)."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, t, kh, h // kh, d).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.reshape(b, h, t, s)

    mask = live_pairs(q_seg, kv_seg, t, s, causal, q.device)[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pg = p.to(q.dtype).float().reshape(b, kh, h // kh, t, s)
    acc = torch.einsum("bkgts,bskd->btkgd", pg, v.to(q.dtype).float())
    o = acc.reshape(b, t, h, d) / l_safe[..., 0].permute(0, 2, 1)[..., None]
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _check_operand(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bf16 {name}, got {x.dtype}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(f"the flash kernels need a unit-stride last dim and "
                         f"16-byte aligned rows for {name}, got strides "
                         f"{x.stride()}")


def _segs_on(seg: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if seg is None:
        return None
    if tuple(seg.shape) != tuple(shape):
        raise ValueError(f"segment ids of shape {tuple(seg.shape)}, "
                         f"expected {tuple(shape)}")
    if seg.device != device:
        raise ValueError(f"segment ids on {seg.device}, operands on {device}")
    return seg.to(torch.int32).contiguous()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_seg: Optional[torch.Tensor] = None,
              kv_seg: Optional[torch.Tensor] = None, *,
              causal: bool = False, scale: Optional[float] = None,
              softcap: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's wrapper: (o [B,T,H,D], lse [B,H,T] f32).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, causal=causal,
                                   scale=scale, softcap=softcap)
    from llavamod_tpu_torch.ops import cuda_build

    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_fwd kernel supports head_dim 64 or 128, got {d}")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        _check_operand(x, name)
    qs = _segs_on(q_seg, (b, t), q.device)
    ks = _segs_on(kv_seg, (b, s), q.device)
    scale = d ** -0.5 if scale is None else scale

    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.llavamod_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qs.data_ptr() if qs is not None else None,
        ks.data_ptr() if ks is not None else None,
        o.data_ptr(), lse.data_ptr(), b, h, kh, t, s, d, strides,
        float(scale), float(softcap or 0.0), int(causal), stream)
    cuda_build.check(err, "flash_fwd launch")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward: K3 (dq) and K4 (dk, dv)
# ---------------------------------------------------------------------------

def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 as [B, H, T] (computed outside the kernels, as
    the JAX _bwd does)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def _bwd_tiles(q, k, v, lse, delta, do, q_seg, kv_seg, causal, scale,
               softcap):
    """The recomputed tiles of the backward, f32 [B, KH, G, T, S]:
    p = exp(softcap(s) - lse) on live pairs (0 elsewhere) and
    ds = p * (dO.V^T - delta) * softcap'(s) * scale."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, t, kh, g, d).float()
    s_raw = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    capped, chain = s_raw, None
    if softcap is not None:
        th = torch.tanh(s_raw / softcap)
        capped, chain = th * softcap, 1.0 - th * th
    mask = live_pairs(q_seg, kv_seg, t, s, causal, q.device)[:, None, None]
    lse_g = lse.reshape(b, kh, g, t)[..., None]
    # the mask goes in before exp: a fully masked row has lse = NEG_INF
    p = torch.where(mask, torch.exp(torch.where(mask, capped - lse_g, 0.0)),
                    0.0)
    dog = do.reshape(b, t, kh, g, d).float()
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.float())
    ds = p * (dp - delta.reshape(b, kh, g, t)[..., None])
    if chain is not None:
        ds = ds * chain
    return p, ds * scale


def _dq_from(ds, q, k):
    b, t, h, d = q.shape
    dq = torch.einsum("bkgts,bskd->btkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, t, h, d).to(q.dtype)


def _dkv_from(p, ds, q, k, v, do):
    b, t, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, t, kh, h // kh, d).float()
    dog = do.reshape(b, t, kh, h // kh, d).float()
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bkgts,btkgd->bskd", ds.to(q.dtype).float(), qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_reference(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                       causal=False, scale=None, softcap=None) -> torch.Tensor:
    """Plain version of K3: dq [B,T,H,D] in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, ds = _bwd_tiles(q, k, v, lse, delta, do, q_seg, kv_seg, causal, scale,
                       softcap)
    return _dq_from(ds, q, k)


def flash_dkv_reference(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                        causal=False, scale=None, softcap=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (dk, dv) [B,S,KH,D] in k's and v's dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = _bwd_tiles(q, k, v, lse, delta, do, q_seg, kv_seg, causal, scale,
                       softcap)
    return _dkv_from(p, ds, q, k, v, do)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        q_seg: Optional[torch.Tensor] = None,
                        kv_seg: Optional[torch.Tensor] = None, *,
                        causal: bool = False, scale: Optional[float] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 + K4: (dq [B,T,H,D], dk, dv [B,S,KH,D]) in the
    dtypes of q, k and v, with the kernels' rounding points; the tiles are
    recomputed once for both."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = _bwd_tiles(q, k, v, lse, _delta(o, do), do, q_seg, kv_seg,
                       causal, scale, softcap)
    return (_dq_from(ds, q, k), *_dkv_from(p, ds, q, k, v, do))


def _bwd_strides(*xs: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *[st for x in xs for st in x.stride()[:3]])


def _bwd_check(q, k, v, do, lse, delta):
    """What K3 and K4 take: bf16 q, k, v, dO through strides (16-byte
    aligned rows), D in {64, 128}, whole GQA groups, and contiguous f32
    [B, H, T] lse and delta."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if do.shape != q.shape:
        raise ValueError(f"dO shape {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash backward kernels support head_dim 64 or "
                         f"128, got {d}")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (do, "dO")):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        _check_operand(x, name)
    for x, name in ((lse, "lse"), (delta, "delta")):
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, t)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B, H, T] on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")


def flash_dq(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
             causal=False, scale=None, softcap=None) -> torch.Tensor:
    """K3's wrapper: dq [B,T,H,D].  delta is rowsum(dO * O) as [B, H, T]
    f32.  CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise."""
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, do, lse, delta, q_seg, kv_seg,
                                  causal=causal, scale=scale, softcap=softcap)
    from llavamod_tpu_torch.ops import cuda_build

    _bwd_check(q, k, v, do, lse, delta)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qs = _segs_on(q_seg, (b, t), q.device)
    ks = _segs_on(kv_seg, (b, s), q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = _bwd_strides(q, k, v, do, dq, k, v)
    err = cuda_build.load_library().llavamod_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        qs.data_ptr() if qs is not None else None,
        ks.data_ptr() if ks is not None else None,
        dq.data_ptr(), b, h, kh, t, s, d, strides, float(scale),
        float(softcap or 0.0), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_dq launch")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
              causal=False, scale=None, softcap=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper: (dk, dv) [B,S,KH,D], summed over the q heads of each
    kv head.  Same rules as `flash_dq`."""
    if not q.is_cuda:
        return flash_dkv_reference(q, k, v, do, lse, delta, q_seg, kv_seg,
                                   causal=causal, scale=scale,
                                   softcap=softcap)
    from llavamod_tpu_torch.ops import cuda_build

    _bwd_check(q, k, v, do, lse, delta)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qs = _segs_on(q_seg, (b, t), q.device)
    ks = _segs_on(kv_seg, (b, s), q.device)
    dk = torch.empty((b, s, kh, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s, kh, d), dtype=v.dtype, device=v.device)
    strides = _bwd_strides(q, k, v, do, q, dk, dv)
    err = cuda_build.load_library().llavamod_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        qs.data_ptr() if qs is not None else None,
        ks.data_ptr() if ks is not None else None,
        dk.data_ptr(), dv.data_ptr(), b, h, kh, t, s, d, strides,
        float(scale), float(softcap or 0.0), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_dkv launch")
    flash_dkv.launches += 1
    return dk, dv


flash_dq.launches = 0
flash_dkv.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              q_seg: Optional[torch.Tensor] = None,
              kv_seg: Optional[torch.Tensor] = None, *,
              causal: bool = False, scale: Optional[float] = None,
              softcap: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention.  CPU tensors run
    `flash_bwd_reference`; CUDA tensors launch K3 and K4 or raise.  dO is
    made contiguous (a no-op for the gradient autograd hands over) and then
    read through strides under K1's alignment check."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, o, lse, do, q_seg, kv_seg,
                                   causal=causal, scale=scale,
                                   softcap=softcap)
    if o.shape != q.shape:
        raise ValueError(f"o shape {tuple(o.shape)} does not match q "
                         f"{tuple(q.shape)}")
    do = do.contiguous()
    delta = _delta(o, do)
    kw = dict(causal=causal, scale=scale, softcap=softcap)
    dq = flash_dq(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K3 + K4 backward (the JAX `_flash` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, softcap):
        o, lse = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal,
                           scale=scale, softcap=softcap)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, q_seg, kv_seg,
                               **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask=None,  # only segment-id masks are supported on this path
    segment_ids: _SegIds = None,
    causal: bool = False,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention. q: [B,T,H,D]; k,v: [B,S,KH,D]. Returns [B,T,H,D].

    Padding/varlen is expressed via segment_ids=(q_seg [B,T], kv_seg [B,S]);
    dense `mask` tensors are not supported here (use impl='xla').  With a
    gradient asked for, the backward runs K3 + K4 (plain version on CPU).
    """
    if mask is not None:
        raise ValueError("flash_attention takes segment_ids, not dense masks")
    q_seg, kv_seg = segment_ids if segment_ids is not None else (None, None)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_seg, kv_seg, causal, scale,
                                    softcap)
    o, _ = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
                     softcap=softcap)
    return o
