"""The port's vocab-chunked losses with int8 heads (llavamod_tpu_torch/
ops/losses.py) against the JAX package's (llavamod_tpu/ops/losses.py), on
the same seeded numpy inputs and the same int8 heads (the JAX quantizer's
arrays on both sides), f32: CE and the sequence log-prob in the exact and
stream_dh modes, KD and KD+CE in the exact, stream_dh, int8_dh and
stream_dh+int8_dh modes, with int8 teacher and student heads.  Losses and
dL/dh agree at 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.models.llm import decoder as jdec
from llavamod_tpu.ops import losses as jl
from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.ops import losses as tl

torch.set_num_threads(2)
LOSS_TOL = 5e-4


def _w(jw) -> Int8Weight:
    """The port's form of a JAX int8 dict, the same arrays."""
    jw = jax.device_get(jw)
    return Int8Weight(torch.tensor(np.asarray(jw["w_int8"])),
                      torch.tensor(np.asarray(jw["scale"])))


B, T, DS, DT, V, LIMIT, CHUNK = 2, 10, 32, 48, 600, 560, 96
MODES = {"exact": (False, False), "stream_dh": (True, False),
         "int8_dh": (False, True), "stream_dh+int8_dh": (True, True)}


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    h_s = rng.randn(B, T, DS).astype(np.float32)
    h_t = rng.randn(B, T, DT).astype(np.float32)
    jw_s = jdec.quantize_head_int8(jnp.asarray(rng.randn(V, DS) * 0.3,
                                               jnp.float32))
    jw_t = jdec.quantize_head_int8(jnp.asarray(rng.randn(V, DT) * 0.3,
                                               jnp.float32))
    labels = rng.randint(0, LIMIT, (B, T)).astype(np.int32)
    labels[:, :3] = -100
    return h_s, h_t, jw_s, jw_t, labels


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("mode", ["exact", "stream_dh"])
@pytest.mark.parametrize("kind", ["ce", "logp"])
def test_ce_and_log_prob_with_an_int8_head(kind, mode):
    h_s, _, jw_s, _, labels = _loss_inputs(5)
    stream = MODES[mode][0]
    kw = dict(vocab_limit=LIMIT, chunk=CHUNK, stream_dh=stream)

    def jf(h):
        if kind == "ce":
            return jl.softmax_cross_entropy(h, jw_s, jnp.asarray(labels),
                                            **kw).loss
        return jl.sequence_log_prob(h, jw_s, jnp.asarray(labels), **kw).sum()

    jloss, jdh = jax.jit(jax.value_and_grad(jf))(jnp.asarray(h_s))
    th = torch.tensor(h_s, requires_grad=True)
    if kind == "ce":
        loss = tl.softmax_cross_entropy(th, _w(jw_s), torch.tensor(labels),
                                        **kw).loss
    else:
        loss = tl.sequence_log_prob(th, _w(jw_s), torch.tensor(labels),
                                    **kw).sum()
    loss.backward()
    _close(loss.item(), jloss)
    _close(th.grad.numpy(), jdh)


@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
@pytest.mark.parametrize("fused", [False, True], ids=["kd", "kd_ce"])
def test_kd_losses_with_int8_heads(fused, mode):
    h_s, h_t, jw_s, jw_t, labels = _loss_inputs(6)
    stream, int8_dh = MODES[mode]
    kw = dict(vocab_limit=LIMIT, chunk=CHUNK, int8_dh=int8_dh,
              stream_dh=stream)

    def jf(h):
        if fused:
            o = jl.kd_ce_align_loss(h, jw_s, jnp.asarray(h_t), jw_t,
                                    jnp.asarray(labels), **kw)
            return o.kd_loss + 0.5 * o.ce_loss, (o.kd_loss, o.ce_loss)
        o = jl.kd_align_loss(h, jw_s, jnp.asarray(h_t), jw_t,
                             jnp.asarray(labels), **kw)
        return o.loss, (o.loss, o.loss)

    (jloss, jparts), jdh = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(h_s))
    th = torch.tensor(h_s, requires_grad=True)
    args = (th, _w(jw_s), torch.tensor(h_t), _w(jw_t), torch.tensor(labels))
    if fused:
        o = tl.kd_ce_align_loss(*args, **kw)
        loss, parts = o.kd_loss + 0.5 * o.ce_loss, (o.kd_loss, o.ce_loss)
    else:
        o = tl.kd_align_loss(*args, **kw)
        loss, parts = o.loss, (o.loss, o.loss)
    loss.backward()
    _close(loss.item(), jloss)
    for g, w in zip(parts, jparts):
        _close(g.item(), w)
    _close(th.grad.numpy(), jdh)
