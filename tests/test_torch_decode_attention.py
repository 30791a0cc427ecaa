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
    flash_decode,
    flash_decode_reference,
)

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
