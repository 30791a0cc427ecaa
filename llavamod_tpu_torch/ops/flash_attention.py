"""Flash attention forward: kernel K1 (csrc/flash_fwd.cu) and its plain
PyTorch version.

Port of llavamod_tpu/ops/flash_attention.py (forward only).  The layout at
the API is [B, T, H, D] for q and [B, S, KH, D] for k/v, as in the JAX
package; the kernel reads it through strides, so no transpose copy is made.
Varlen batches are expressed with segment ids (0 = padding).  Causal masking
is aligned at the start (column <= row), as in the JAX flash kernel.

  * `flash_fwd` — the kernel's wrapper.  A CUDA tensor launches K1 (bf16,
    D in {64, 128}) or raises; a CPU tensor goes to `flash_fwd_reference`.
    `flash_fwd.launches` counts kernel launches.
  * `flash_fwd_reference` — the plain version: same masks, same f32 softmax
    statistics, probabilities cast to the input dtype before P.V, output 0
    and lse NEG_INF on fully masked rows.
  * `flash_attention` — the public function of the JAX package.

Forward only: the backward kernels (`_dq_kernel`, `_dkv_kernel`) come with
the training slice, so asking a CUDA call for a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_SegIds = Optional[Tuple[torch.Tensor, torch.Tensor]]


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

    mask = torch.ones((1, 1, t, s), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        mask = mask & (cols <= rows)
    if q_seg is not None:
        mask = mask & ((q_seg[:, None, :, None] == kv_seg[:, None, None, :])
                       & (kv_seg[:, None, None, :] != 0))
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
        raise TypeError(f"flash_fwd kernel takes bf16 {name}, got {x.dtype}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(f"flash_fwd kernel needs a unit-stride last dim and "
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
    dense `mask` tensors are not supported here (use impl='xla').
    """
    if mask is not None:
        raise ValueError("flash_attention takes segment_ids, not dense masks")
    if (q.is_cuda and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        raise NotImplementedError(
            "flash attention backward (the _dq_kernel/_dkv_kernel port) "
            "comes with the training slice; run under torch.no_grad()")
    q_seg, kv_seg = segment_ids if segment_ids is not None else (None, None)
    o, _ = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal, scale=scale,
                     softcap=softcap)
    return o
