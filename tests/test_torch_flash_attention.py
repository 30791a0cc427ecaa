"""K1's plain version (llavamod_tpu_torch/ops/flash_attention.py) against
the JAX package: `xla_attention` and the Pallas `flash_attention` in
interpret mode.  Left-pad query rows are fully masked, where the two JAX
paths differ (uniform average vs 0), so outputs are compared on non-pad rows
only; the port's plain version follows the flash kernel there (0, and lse
NEG_INF).  f32, tolerance 1e-5.  The CUDA kernel itself is held against
this plain version on the card (tests/test_torch_gpu_kernels.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.ops.attention import xla_attention
from llavamod_tpu.ops.flash_attention import flash_attention as jflash
from llavamod_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_fwd,
    flash_fwd_reference,
)

torch.set_num_threads(2)
TOL = 1e-5


def _inputs(b, t, h, kh, d, lengths, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, t, kh, d).astype(np.float32)
    v = rng.randn(b, t, kh, d).astype(np.float32)
    seg = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        seg[i, t - n:] = 1
    return q, k, v, seg


@pytest.mark.parametrize("h,kh,softcap", [(4, 4, None), (4, 2, None),
                                          (4, 1, 20.0)],
                         ids=["mha", "gqa", "softcap"])
def test_plain_k1_matches_jax_xla_attention(h, kh, softcap):
    q, k, v, seg = _inputs(2, 24, h, kh, 16, [24, 9])
    o, lse = flash_fwd_reference(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), torch.tensor(seg),
                                 torch.tensor(seg), causal=True,
                                 softcap=softcap)
    mask = (seg[:, None, :, None] == seg[:, None, None, :]) & (
        seg[:, None, None, :] != 0)
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask), causal=True, softcap=softcap)
    real = seg.astype(bool)
    np.testing.assert_allclose(o.numpy()[real], np.asarray(ref)[real],
                               rtol=TOL, atol=TOL)
    # fully masked (left-pad) rows: output 0 and lse NEG_INF, as the kernel
    assert (o.numpy()[~real] == 0).all()
    assert (lse.numpy().transpose(0, 2, 1)[~real] == NEG_INF).all()


def test_plain_k1_matches_jax_flash_interpret():
    """One small shape through the Pallas kernel in interpret mode."""
    q, k, v, seg = _inputs(2, 128, 2, 1, 64, [128, 37], seed=1)
    segs_t = (torch.tensor(seg), torch.tensor(seg))
    out = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          segment_ids=segs_t, causal=True)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 segment_ids=(jnp.asarray(seg), jnp.asarray(seg)),
                 causal=True, block_q=128, block_k=128)
    real = seg.astype(bool)
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy()[~real], np.asarray(ref)[~real],
                               atol=TOL)  # both 0 on pad rows


def test_plain_k1_without_segments_and_lse():
    q, k, v, _ = _inputs(1, 10, 2, 2, 8, [10], seed=2)
    o, lse = flash_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                       causal=False)
    ref = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    logits = np.einsum("bthd,bshd->bhts", q, k) * 8 ** -0.5
    m = logits.max(-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_wrapper_rejects_half_given_segments_and_dense_masks():
    x = torch.zeros((1, 4, 2, 8))
    seg = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_fwd(x, x, x, seg, None)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, mask=torch.ones((1, 1, 4, 4), dtype=torch.bool))
