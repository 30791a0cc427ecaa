"""Flash-decode attention over the (optionally int8) KV cache: kernel K2
(csrc/flash_decode.cu) and its plain PyTorch version.

Port of llavamod_tpu/ops/decode_attention.py.  The cached decode step
(t == 1) re-reads the whole [B, KH, S, D] cache once per generated token;
the kernel reads it in its stored dtype (bf16, f32, or int8 with f32
per-slot scales [B, KH, S]), folds the k-scale into the logits and the
v-scale into the probabilities, and masks empty slots through the cache
segment row (0 = empty/pad).

  * `flash_decode` — the kernel's wrapper.  A CUDA tensor launches K2 or
    raises; a CPU tensor goes to `flash_decode_reference`.
    `flash_decode.launches` counts kernel launches (one per call: the split
    kernel and its combine pass); `flash_decode.int8_launches` counts those
    of them that read an int8 cache.
  * `flash_decode_reference` — the plain version, the same arithmetic over
    the whole cache row at once.
  * `decode_splits` / `split_bounds` — how K2 cuts the cache length across
    blocks (flash-decoding), in plain Python so the choice is testable
    without a card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from llavamod_tpu_torch.ops.flash_attention import refuse_dtensor

NEG_INF = -1e30
MAX_GROUP = 8  # query heads per kv head the kernel takes
SPLIT_SLOTS = 128  # a split owns a whole number of these cache slots
H100_SMS = 132
# blocks per SM the split count aims for: at the serving shape targets of
# 1 to 6 timed within the noise of each other on an H100, 2 among the best
BLOCKS_PER_SM = 2

_Q_CODES = {torch.bfloat16: 0, torch.float32: 1}
_CACHE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def decode_splits(b: int, kh: int, s: int, sms: int = H100_SMS) -> int:
    """How many splits K2 cuts a cache of `s` slots into: enough blocks
    (splits x KH x B) for BLOCKS_PER_SM per SM of `sms`, and at least one
    SPLIT_SLOTS span per split, so within [1, ceil(s / SPLIT_SLOTS)]."""
    spans = -(-s // SPLIT_SLOTS)
    want = -(-(BLOCKS_PER_SM * sms) // (b * kh))
    return max(1, min(spans, want))


def split_bounds(s: int, splits: int, i: int) -> Tuple[int, int]:
    """Slots [begin, end) of split i: a balanced share of the cache's
    SPLIT_SLOTS spans, as the kernel's split_range computes them."""
    spans = -(-s // SPLIT_SLOTS)
    return (i * spans // splits * SPLIT_SLOTS,
            min(s, (i + 1) * spans // splits * SPLIT_SLOTS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_seg: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of K2.  q [B,H,D]; k, v [B,KH,S,D]; scales [B,KH,S]
    (int8 cache) or None; kv_seg [B,S].  Returns [B,H,D] in q.dtype."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    quantized = k_scale is not None
    qg = q.reshape(b, kh, g, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg,
                          k.to(q.dtype).float()) * scale
    if quantized:
        logits = logits * k_scale[:, :, None, :].float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    mask = (kv_seg != 0)[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        pv = p * v_scale[:, :, None, :].float()
        vf = v.float()
    else:  # p in the cache dtype before P.V, as the kernel does
        pv = p.to(v.dtype).float()
        vf = v.float()
    acc = torch.einsum("bkgs,bksd->bkgd", pv, vf)
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_seg: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-step cached attention.

    q:       [B, H, D] current-token queries.
    k, v:    [B, KH, S, D] cache — int8 iff k_scale/v_scale given, else
             bf16 or f32 (read as-is).
    k_scale, v_scale: [B, KH, S] f32 per-slot dequantization scales.
    kv_seg:  [B, S] int cache segment row; 0 marks empty/pad slots.
             (Causality is implied: slots not yet written are still 0.)
    scale:   logit scale (default D**-0.5).
    Returns [B, H, D] in q.dtype.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    refuse_dtensor(q, k, v)
    if not q.is_cuda:
        return flash_decode_reference(q, k, v, kv_seg=kv_seg, k_scale=k_scale,
                                      v_scale=v_scale, scale=scale,
                                      softcap=softcap)
    from llavamod_tpu_torch.ops import cuda_build

    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if k.shape != (b, kh, s, d) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_decode kernel supports head_dim 64 or 128, got {d}")
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"flash_decode kernel takes up to {MAX_GROUP} query "
                         f"heads per kv head, got H={h} KH={kh}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"flash_decode kernel takes bf16/f32 queries, got {q.dtype}")
    if k.dtype not in _CACHE_CODES or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel takes a bf16/f32/int8 cache, "
                        f"got {k.dtype}/{v.dtype}")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None):
        raise ValueError("an int8 cache needs k_scale/v_scale, a float one none")
    tensors = [q, k, v, kv_seg] + ([k_scale, v_scale] if quantized else [])
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"operand on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_decode kernel needs contiguous operands, "
                             f"got strides {x.stride()}")
    if kv_seg.shape != (b, s):
        raise ValueError(f"kv_seg shape {tuple(kv_seg.shape)}, expected {(b, s)}")
    if quantized:
        for x in (k_scale, v_scale):
            if x.shape != (b, kh, s) or x.dtype != torch.float32:
                raise ValueError(f"scales must be f32 {(b, kh, s)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode kernel needs 16-byte aligned caches")
    seg = kv_seg.to(torch.int32)
    scale = d ** -0.5 if scale is None else scale
    splits = decode_splits(b, kh, s, _sm_count(q.device.index or 0))

    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # the splits' f32 partials in one allocation: acc [B, H, splits, D],
    # then m and l [B, H, splits]
    n = b * h * splits
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    acc_ptr = part.data_ptr()
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.llavamod_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        seg.data_ptr(), out.data_ptr(), acc_ptr, acc_ptr + 4 * n * d,
        acc_ptr + 4 * n * (d + 1), b, h, kh, s, d, splits,
        _Q_CODES[q.dtype], _CACHE_CODES[k.dtype], float(scale),
        float(softcap or 0.0), stream)
    cuda_build.check(err, "flash_decode launch")
    flash_decode.launches += 1
    flash_decode.int8_launches += quantized
    return out


flash_decode.launches = 0
flash_decode.int8_launches = 0
