"""Plain ops of the PyTorch port against the JAX package on the CPU:
norms, rope, and the plain attention (GQA, causal, segments, softcap, dense
mask and bias, both KV layouts).  f32, tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.ops import attention as jattn
from llavamod_tpu.ops import norms as jnorms
from llavamod_tpu.ops import rope as jrope
from llavamod_tpu_torch.ops import attention as tattn
from llavamod_tpu_torch.ops import norms as tnorms
from llavamod_tpu_torch.ops import rope as trope

torch.set_num_threads(2)
TOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    x, w = _rand((2, 5, 16), 0), _rand((16,), 1)
    _close(tnorms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6, offset),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset))


def test_norms_cast_back_to_bf16():
    x = torch.tensor(_rand((3, 8), 2)).bfloat16()
    w = torch.ones(8, dtype=torch.bfloat16)
    assert tnorms.rms_norm(x, w).dtype == torch.bfloat16
    assert tnorms.layer_norm(x, w, None).dtype == torch.bfloat16


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm(with_bias):
    x, w, b = _rand((2, 5, 16), 0, 3.0), _rand((16,), 1), _rand((16,), 2)
    bt = torch.tensor(b) if with_bias else None
    bj = jnp.asarray(b) if with_bias else None
    _close(tnorms.layer_norm(torch.tensor(x), torch.tensor(w), bt, 1e-5),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), bj, 1e-5))


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rope(rotary_dim):
    pos = np.random.RandomState(0).randint(0, 500, (2, 7)).astype(np.int32)
    x = _rand((2, 7, 3, 16), 1)
    ct, st = trope.rope_table(torch.tensor(pos), 16, 1e4, rotary_dim)
    cj, sj = jrope.rope_table(jnp.asarray(pos), 16, 1e4, rotary_dim)
    _close(ct, cj)
    _close(st, sj)
    _close(trope.apply_rope(torch.tensor(x), ct, st),
           jrope.apply_rope(jnp.asarray(x), cj, sj))


def test_make_causal_mask_is_end_aligned():
    t = tattn.make_causal_mask(3, 5).numpy()
    j = np.asarray(jattn.make_causal_mask(3, 5))
    assert (t == j).all()
    assert t[0].tolist() == [True, True, True, False, False]


ATTN_CASES = [
    # B, T, S, H, KH, D, causal, softcap, segs, mask, bias, layout
    (2, 6, 6, 4, 4, 8, False, None, False, False, False, "bskd"),
    (2, 6, 6, 4, 2, 8, True, None, False, False, False, "bskd"),    # GQA
    (2, 6, 6, 6, 2, 8, True, None, True, False, False, "bskd"),     # segments
    (2, 6, 6, 4, 1, 8, True, 5.0, True, False, False, "bskd"),      # softcap
    (2, 3, 7, 4, 2, 8, True, None, False, True, True, "bskd"),      # mask+bias
    (2, 1, 9, 4, 2, 8, False, None, False, True, False, "bksd"),    # cache layout
]


@pytest.mark.parametrize(
    "b,t,s,h,kh,d,causal,softcap,segs,mask,bias,layout", ATTN_CASES,
    ids=["plain", "gqa", "segments", "softcap", "mask_bias", "bksd"])
def test_plain_attention_matches_jax(b, t, s, h, kh, d, causal, softcap, segs,
                                     mask, bias, layout):
    q = _rand((b, t, h, d), 0)
    kv_shape = (b, s, kh, d) if layout == "bskd" else (b, kh, s, d)
    k, v = _rand(kv_shape, 1), _rand(kv_shape, 2)
    kw_t, kw_j = {}, {}
    if segs:
        seg = np.ones((b, s), np.int32)
        seg[0, :2] = 0                      # left padding
        seg[1, 3:] = 2                      # two packed sequences
        kw_t["segment_ids"] = (torch.tensor(seg), torch.tensor(seg))
        kw_j["segment_ids"] = (jnp.asarray(seg), jnp.asarray(seg))
    if mask:
        m = np.random.RandomState(3).rand(b, 1, t, s) > 0.3
        m[..., -1] = True
        kw_t["mask"], kw_j["mask"] = torch.tensor(m), jnp.asarray(m)
    if bias:
        bb = _rand((b, h, t, s), 4)
        kw_t["bias"], kw_j["bias"] = torch.tensor(bb), jnp.asarray(bb)
    out_t = tattn.dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        softcap=softcap, kv_layout=layout, **kw_t)
    out_j = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap, kv_layout=layout, impl="xla", **kw_j)
    _close(out_t, out_j)


def test_auto_dispatch_takes_the_plain_version_on_cpu():
    q = torch.tensor(_rand((1, 4, 2, 8), 0))
    a = tattn.dot_product_attention(q, q, q, causal=True)
    b = tattn.xla_attention(q, q, q, causal=True)
    assert torch.equal(a, b)
