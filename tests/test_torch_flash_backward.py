"""The flash-attention backward of the port (the autograd Function whose
backward is K3 + K4, on the CPU their plain version `flash_bwd_reference`)
against `jax.vjp` of the JAX package's Pallas `flash_attention`, whose
backward runs `_dq_kernel` and `_dkv_kernel` in interpret mode.  Same seeded
inputs and cotangent; f32, tolerance 5e-4 (as tests/test_ops_attention.py).
Left-pad query rows are fully masked: both sides give them zero dq, and keys
no row can see get zero dk and dv.  The CUDA kernels themselves are held
against the plain version on the card (tests/test_torch_gpu_kernels.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.ops.flash_attention import flash_attention as jflash
from llavamod_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_bwd,
    flash_dkv,
    flash_dq,
    flash_fwd,
)

torch.set_num_threads(2)
TOL = 5e-4
T = 200  # not a block multiple: the JAX wrapper pads, the port masks tails


def _inputs(b, t, h, kh, d, lengths, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, t, kh, d).astype(np.float32)
    v = rng.randn(b, t, kh, d).astype(np.float32)
    g = rng.randn(b, t, h, d).astype(np.float32)
    seg = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        seg[i, t - n:] = 1
    return q, k, v, g, seg


CASES = [  # causal, segments, H, KH, D, softcap
    (True, True, 4, 2, 64, None),
    (True, False, 4, 4, 128, None),
    (False, True, 4, 2, 128, 30.0),
    (True, True, 4, 2, 128, 30.0),
    (False, False, 4, 2, 64, None),
]


@pytest.mark.parametrize("causal,use_seg,h,kh,d,softcap", CASES,
                         ids=["causal-seg-gqa-d64", "causal-mha-d128",
                              "seg-gqa-softcap-d128",
                              "causal-seg-gqa-softcap-d128", "gqa-d64"])
def test_flash_backward_matches_jax_pallas(causal, use_seg, h, kh, d,
                                           softcap):
    q, k, v, g, seg = _inputs(2, T, h, kh, d, [T, 77], seed=d + h + kh)
    jsegs = (jnp.asarray(seg), jnp.asarray(seg)) if use_seg else None

    def jf(q_, k_, v_):
        return jflash(q_, k_, v_, segment_ids=jsegs, causal=causal,
                      softcap=softcap)

    o_j, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tsegs = (torch.tensor(seg), torch.tensor(seg)) if use_seg else None
    o_t = flash_attention(tq, tk, tv, segment_ids=tsegs, causal=causal,
                          softcap=softcap)
    dq_t, dk_t, dv_t = torch.autograd.grad(o_t, (tq, tk, tv),
                                           torch.tensor(g))

    rows = seg.astype(bool) if use_seg else np.ones(seg.shape, bool)
    np.testing.assert_allclose(o_t.detach().numpy()[rows],
                               np.asarray(o_j)[rows], rtol=TOL, atol=TOL)
    for got, want in ((dq_t, dq_j), (dk_t, dk_j), (dv_t, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    if use_seg:
        pad = ~seg.astype(bool)
        assert (dq_t.numpy()[pad] == 0).all()
        assert (dk_t.numpy()[pad] == 0).all() and (dv_t.numpy()[pad] == 0).all()


def test_wrappers_split_the_backward_and_count_no_cpu_launch():
    """flash_dq + flash_dkv with delta = rowsum(dO*O) give flash_bwd's
    result; on the CPU no kernel is launched, so no count moves."""
    q, k, v, g, seg = _inputs(1, 40, 4, 2, 64, [29], seed=3)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    ts = torch.tensor(seg)
    o, lse = flash_fwd(tq, tk, tv, ts, ts, causal=True)
    counts = (flash_dq.launches, flash_dkv.launches)
    dq, dk, dv = flash_bwd(tq, tk, tv, o, lse, tg, ts, ts, causal=True)
    delta = (tg * o).sum(-1).permute(0, 2, 1).contiguous()
    dq2 = flash_dq(tq, tk, tv, tg, lse, delta, ts, ts, causal=True)
    dk2, dv2 = flash_dkv(tq, tk, tv, tg, lse, delta, ts, ts, causal=True)
    for a, b_ in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert (flash_dq.launches, flash_dkv.launches) == counts
    with pytest.raises(ValueError):
        flash_bwd(tq, tk, tv, o, lse, tg, ts, None)
