"""The port's vocab-chunked losses (llavamod_tpu_torch/ops/losses.py)
against the JAX package's (llavamod_tpu/ops/losses.py): values and the
gradients to the student hidden states and head, same seeded inputs, f32,
tolerance 5e-4.  The vocab (1000 rows) is cut to a `vocab_limit` below the
head's rows, and the chunk (96) does not divide it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.ops import losses as jl
from llavamod_tpu_torch.ops import losses as tl

torch.set_num_threads(2)
TOL = 5e-4
B, T, DS, DT, V, LIMIT, CHUNK = 2, 12, 32, 48, 1000, 900, 96


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    h_s = rng.randn(B, T, DS).astype(np.float32)
    w_s = (rng.randn(V, DS) * 0.3).astype(np.float32)
    h_t = rng.randn(B, T, DT).astype(np.float32)
    w_t = (rng.randn(V, DT) * 0.3).astype(np.float32)
    labels = rng.randint(0, LIMIT, (B, T)).astype(np.int32)
    labels[:, :4] = -100
    labels[1, 7] = LIMIT + 20   # past the vocab limit: CE drops it
    labels[0, 9] = -100
    return h_s, w_s, h_t, w_t, labels


def _torch_grads(fn, h_s, w_s, *rest):
    th = torch.tensor(h_s, requires_grad=True)
    tw = torch.tensor(w_s, requires_grad=True)
    out = fn(th, tw, *(torch.tensor(x) if isinstance(x, np.ndarray) else x
                       for x in rest))
    return out, th, tw


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_softmax_cross_entropy_value_and_grads():
    h_s, w_s, _, _, labels = _inputs(1)
    labels = np.minimum(labels, LIMIT - 1)

    def jf(h, w):
        out = jl.softmax_cross_entropy(h, w, jnp.asarray(labels),
                                       vocab_limit=LIMIT, chunk=CHUNK)
        return out.loss, out.num_tokens

    (jloss, jn), (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(h_s), jnp.asarray(w_s))
    out, th, tw = _torch_grads(
        lambda h, w, lab: tl.softmax_cross_entropy(h, w, lab,
                                                   vocab_limit=LIMIT,
                                                   chunk=CHUNK),
        h_s, w_s, labels)
    out.loss.backward()
    _close(out.loss.item(), jloss)
    assert out.num_tokens.item() == float(jn)
    _close(th.grad.numpy(), jdh)
    _close(tw.grad.numpy(), jdw)
    assert (tw.grad.numpy()[LIMIT:] == 0).all()


@pytest.mark.parametrize("fused", [False, True], ids=["kd", "kd_ce"])
@pytest.mark.parametrize("distill_all", [False, True],
                         ids=["response-mask", "all-tokens"])
def test_kd_losses_value_and_grads(fused, distill_all):
    h_s, w_s, h_t, w_t, labels = _inputs(2)
    kw = dict(vocab_limit=LIMIT, chunk=CHUNK, distill_all_tokens=distill_all)
    jlab = jnp.asarray(labels)

    def jf(h, w):
        if fused:
            o = jl.kd_ce_align_loss(h, w, jnp.asarray(h_t), jnp.asarray(w_t),
                                    jlab, **kw)
            return o.kd_loss + o.ce_loss, (o.kd_loss, o.ce_loss,
                                           o.kd_tokens, o.ce_tokens)
        o = jl.kd_align_loss(h, w, jnp.asarray(h_t), jnp.asarray(w_t), jlab,
                             **kw)
        return o.loss, (o.loss, o.num_tokens)

    (jloss, jaux), (jdh, jdw) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(h_s), jnp.asarray(w_s))

    if fused:
        out, th, tw = _torch_grads(
            lambda h, w, ht, wt, lab: tl.kd_ce_align_loss(h, w, ht, wt, lab,
                                                          **kw),
            h_s, w_s, h_t, w_t, labels)
        total = out.kd_loss + out.ce_loss
        got_aux = (out.kd_loss, out.ce_loss, out.kd_tokens, out.ce_tokens)
    else:
        out, th, tw = _torch_grads(
            lambda h, w, ht, wt, lab: tl.kd_align_loss(h, w, ht, wt, lab,
                                                       **kw),
            h_s, w_s, h_t, w_t, labels)
        total = out.loss
        got_aux = (out.loss, out.num_tokens)
    total.backward()
    _close(total.item(), jloss)
    for g, w in zip(got_aux, jaux):
        _close(g.item(), w)
    _close(th.grad.numpy(), jdh)
    _close(tw.grad.numpy(), jdw)


def test_frozen_head_takes_no_gradient_and_int8_modes_wait():
    h_s, w_s, h_t, w_t, labels = _inputs(3)
    th = torch.tensor(h_s, requires_grad=True)
    tw = torch.tensor(w_s)            # frozen head: no dW is formed
    out = tl.kd_ce_align_loss(th, tw, torch.tensor(h_t), torch.tensor(w_t),
                              torch.tensor(labels), vocab_limit=LIMIT,
                              chunk=CHUNK)
    (out.kd_loss + out.ce_loss).backward()
    assert th.grad is not None and tw.grad is None
    # the int8 modes are ported (tests/test_torch_int8.py); with a float
    # head they change nothing: stream_dh and int8_dh give the same bits
    th2 = torch.tensor(h_s, requires_grad=True)
    out2 = tl.kd_ce_align_loss(th2, tw, torch.tensor(h_t), torch.tensor(w_t),
                               torch.tensor(labels), vocab_limit=LIMIT,
                               chunk=CHUNK, stream_dh=True, int8_dh=True)
    (out2.kd_loss + out2.ce_loss).backward()
    assert torch.equal(out2.kd_loss, out.kd_loss)
    assert torch.equal(th2.grad, th.grad) and tw.grad is None
