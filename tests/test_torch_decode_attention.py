"""K2's plain version (llavamod_tpu_torch/ops/decode_attention.py) against
the JAX package: the Pallas `flash_decode` in interpret mode and the XLA
branch of the cached decode (decoder.py:868-890), for float caches holding
bf16-representable values and for int8 caches with per-slot scales.
f32 compute, tolerance 1e-5 (float caches) and 1e-4 (int8: the two sides
fold the scales in at different points of f32 arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.models.llm.decoder import _dequantize_kv, _quantize_kv
from llavamod_tpu.ops.attention import dot_product_attention
from llavamod_tpu.ops.decode_attention import flash_decode as jflash_decode
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.ops.decode_attention import (
    SPLIT_SLOTS,
    decode_splits,
    flash_decode,
    flash_decode_reference,
    split_bounds,
)
from llavamod_tpu_torch.ops.tolerance import tol_ratio, within_tol

torch.set_num_threads(2)


def _bf16_valued(x):
    return np.asarray(torch.tensor(x).bfloat16().float())


def _case(b, h, kh, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q = _bf16_valued(rng.randn(b, h, d).astype(np.float32))
    k = _bf16_valued(rng.randn(b, kh, s, d).astype(np.float32))
    v = _bf16_valued(rng.randn(b, kh, s, d).astype(np.float32))
    seg = np.ones((b, s), np.int32)
    seg[:, :3] = 0        # left padding
    seg[:, -5:] = 0       # slots not yet written
    seg[0, :s // 2] = 0
    return q, k, v, seg


CASES = [(2, 4, 4, 40, 16, None), (2, 6, 2, 33, 16, None),
         (3, 4, 1, 64, 8, 30.0)]


@pytest.mark.parametrize("b,h,kh,s,d,softcap", CASES,
                         ids=["mha", "gqa", "mqa_softcap"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_plain_k2_matches_jax_flash_decode_interpret(b, h, kh, s, d, softcap,
                                                     quantized):
    q, k, v, seg = _case(b, h, kh, s, d)
    jkw, tkw = {}, {}
    kk, vv = jnp.asarray(k), jnp.asarray(v)
    if quantized:
        kk, ks = _quantize_kv(kk)
        vv, vs = _quantize_kv(vv)
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=torch.tensor(np.asarray(ks)),
                   v_scale=torch.tensor(np.asarray(vs)))
    ref = jflash_decode(jnp.asarray(q), kk, vv, kv_seg=jnp.asarray(seg),
                        softcap=softcap, **jkw)
    out = flash_decode(torch.tensor(q), torch.tensor(np.asarray(kk)),
                       torch.tensor(np.asarray(vv)), kv_seg=torch.tensor(seg),
                       softcap=softcap, **tkw)
    tol = 1e-4 if quantized else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_plain_k2_matches_jax_xla_decode_branch(quantized):
    """The XLA branch of decoder.attention_forward: dequantize, mask by
    position and segment, plain attention over the bksd cache."""
    b, h, kh, s, d = 2, 4, 2, 24, 16
    q, k, v, seg = _case(b, h, kh, s, d, seed=3)
    start = s - 6                                   # the new token's slot
    seg[:, start + 1:] = 0
    seg[:, start] = 1
    kk, vv = jnp.asarray(k), jnp.asarray(v)
    tkw = {}
    if quantized:
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        tk, tv = np.asarray(kq), np.asarray(vq)
        kk, vv = _dequantize_kv(kq, ks, jnp.float32), _dequantize_kv(vq, vs, jnp.float32)
        tkw = dict(k_scale=torch.tensor(np.asarray(ks)),
                   v_scale=torch.tensor(np.asarray(vs)))
    else:
        tk, tv = k, v
    kv_pos = jnp.arange(s)[None, None, None, :]
    mask = (kv_pos <= start) & (jnp.asarray(seg)[:, None, None, :] != 0)
    ref = dot_product_attention(jnp.asarray(q)[:, None], kk, vv, mask=mask,
                                causal=False, impl="xla", kv_layout="bksd")[:, 0]
    out = flash_decode_reference(torch.tensor(q), torch.tensor(tk),
                                 torch.tensor(tv), kv_seg=torch.tensor(seg),
                                 **tkw)
    tol = 1e-4 if quantized else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _bf16_round(x):
    return torch.tensor(x).bfloat16().float().numpy()


def _split_decode_model(q, k, v, seg, splits, k_scale=None, v_scale=None):
    """numpy model of K2's split decode (csrc/flash_decode.cu): each split
    of `split_bounds` takes its own max, rounds p to bf16 against it (a bf16
    cache) or scales it by v_scale and keeps it f32 (int8), and its partials
    (m, l, acc) are combined in order."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    logits = np.einsum("bkgd,bksd->bkgs", q.reshape(b, kh, h // kh, d),
                       k.astype(np.float32)) * d ** -0.5
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    live = (seg != 0)[:, None, None, :]
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = split_bounds(s, splits, i)
        assert lo < hi
        lg = np.where(live[..., lo:hi], logits[..., lo:hi], -1e30)
        m = lg.max(-1, keepdims=True)
        p = np.where(live[..., lo:hi], np.exp(lg - m), 0.0)
        pv = (p * v_scale[:, :, None, lo:hi] if v_scale is not None
              else _bf16_round(p))
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        accs.append(np.einsum("bkgs,bksd->bkgd", pv,
                              v[:, :, lo:hi].astype(np.float32)))
    mx = np.max(ms, axis=0)
    w = [np.exp(m - mx) for m in ms]
    l = sum(li * wi for li, wi in zip(ls, w))
    acc = sum(ai * wi[..., None] for ai, wi in zip(accs, w))
    return (acc / np.where(l == 0.0, 1.0, l)[..., None]).reshape(b, h, d)


@pytest.mark.parametrize("splits", [1, 3, 9])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_split_decode_model_matches_jax_flash_decode(splits, quantized):
    """K2 rounds p to bf16 against its split's running max, not against one
    max over the whole cache row: at the serving cache length (S = 1056,
    nine 128-slot spans) the split model stays within the kernel tolerance
    of JAX's flash_decode (interpret mode), with bf16 q and a bf16 cache,
    and with an int8 cache."""
    b, h, kh, s, d = 4, 4, 2, 1056, 64
    q, k, v, seg = _case(b, h, kh, s, d, seed=7)
    seg[1, :] = 0
    seg[1, 600:700] = 1      # live slots inside one split (of 3 or 9)
    seg[2, :] = 0
    seg[2, 77] = 1           # one live slot
    seg[3, :] = 0            # none: the output is 0
    jq = jnp.asarray(q, dtype=jnp.bfloat16)
    if quantized:
        kk, ks = _quantize_kv(jnp.asarray(k))
        vv, vs = _quantize_kv(jnp.asarray(v))
        jkw = dict(k_scale=ks, v_scale=vs)
        mkw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    else:
        kk = jnp.asarray(k, dtype=jnp.bfloat16)
        vv = jnp.asarray(v, dtype=jnp.bfloat16)
        jkw, mkw = {}, {}
    ref = jflash_decode(jq, kk, vv, kv_seg=jnp.asarray(seg), **jkw)
    got = _split_decode_model(q, np.asarray(kk, np.float32),
                              np.asarray(vv, np.float32), seg, splits, **mkw)
    want = torch.tensor(np.asarray(ref, np.float32))
    assert within_tol(torch.tensor(got).bfloat16(), want), \
        tol_ratio(torch.tensor(got).bfloat16(), want)
    assert (got[3] == 0).all()


def test_decode_splits_range_and_occupancy():
    """Within [1, ceil(S / 128)] always; at B * KH = 16 (the streamed
    request) at least 2 * 132 blocks whenever S has the spans for it; at
    the serving batch (B = 8, KH = 16) more blocks than SMs."""
    for b in (1, 2, 3, 8, 24, 64):
        for kh in (1, 2, 16):
            for s in (1, 127, 128, 129, 1056, 2048, 2049, 4200, 32768):
                n = decode_splits(b, kh, s)
                assert 1 <= n <= -(-s // SPLIT_SLOTS)
                if b * kh == 16 and -(-s // SPLIT_SLOTS) >= 17:
                    assert n * b * kh >= 2 * 132
    assert decode_splits(8, 16, 1056) * 8 * 16 > 132
    assert decode_splits(1, 16, 1056) == 9       # one span per split
    assert decode_splits(1, 16, 1056, sms=8) == 1


@pytest.mark.parametrize("s", [1, 127, 128, 129, 1056, 4200])
def test_split_bounds_tile_the_cache(s):
    spans = -(-s // SPLIT_SLOTS)
    for splits in sorted({1, 2, 3, spans}):
        if splits > spans:
            continue
        bounds = [split_bounds(s, splits, i) for i in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == s
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert hi == lo2 and hi % SPLIT_SLOTS == 0
        assert all(lo < hi for lo, hi in bounds)


def test_quantize_kv_matches_jax():
    x = np.random.RandomState(5).randn(2, 3, 7, 16).astype(np.float32)
    qj, sj = _quantize_kv(jnp.asarray(x))
    qt, st = tdecoder._quantize_kv(torch.tensor(x))
    assert (qt.numpy() == np.asarray(qj)).all()
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)


def test_wrapper_rejects_half_given_scales():
    q = torch.zeros((1, 2, 8))
    c = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError):
        flash_decode(q, c, c, kv_seg=torch.ones((1, 4), dtype=torch.int32),
                     k_scale=torch.ones((1, 2, 4)))
