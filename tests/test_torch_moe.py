"""MoE gating and gather dispatch of the port against the JAX package: the
same expert / slot / kept assignment exactly (tied logits included), the
same renormalised weights, aux loss and routed FFN output (f32, 1e-5)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llavamod_tpu.ops import moe as jmoe
from llavamod_tpu_torch.ops import moe as tmoe

torch.set_num_threads(2)
TOL = 1e-5


def _logits(s, e, seed, ties):
    rng = np.random.RandomState(seed)
    x = rng.randn(s, e).astype(np.float32)
    if ties:
        x[: s // 2] = np.round(x[: s // 2])       # many exact ties
        x[0] = 0.0                                # all experts tied
        x[1, :2] = 3.0                            # tie for the top choice
    return x


@pytest.mark.parametrize("s,e,k,cap_f,min_cap,ties,pad", [
    (32, 4, 2, 2.0, 4, False, False),
    (32, 4, 2, 0.5, 1, True, True),    # heavy dropping, ties, padding
    (20, 8, 1, 1.0, 4, True, False),   # top-1: raw gate, no renorm
    (16, 4, 3, 1.0, 2, False, True),
], ids=["top2", "top2_drops_ties_pad", "top1", "top3"])
def test_gating_assignment_is_identical(s, e, k, cap_f, min_cap, ties, pad):
    logits = _logits(s, e, 0, ties)
    valid = np.ones((s,), bool)
    if pad:
        valid[:5] = False
    gj = jmoe.GatingConfig(num_experts=e, top_k=k, eval_capacity_factor=cap_f,
                           min_capacity=min_cap)
    gt = tmoe.GatingConfig(**dataclasses.asdict(gj))
    assert gt.capacity(s, False) == gj.capacity(s, False)
    assert gt.capacity(s, True) == gj.capacity(s, True)
    cj = jmoe.top_k_gating_compact(jnp.asarray(logits), gj, train=False,
                                   token_valid=jnp.asarray(valid))
    ct = tmoe.top_k_gating_compact(torch.tensor(logits), gt, train=False,
                                   token_valid=torch.tensor(valid))
    for name in ("expert", "slot", "kept"):
        assert (getattr(ct, name).numpy() == np.asarray(getattr(cj, name))).all(), name
    for name in ("weight", "aux_loss", "expert_load", "router_probs"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_capacity_is_an_integer_ceil():
    g = tmoe.GatingConfig(num_experts=4, top_k=2, eval_capacity_factor=2.0,
                          min_capacity=4)
    assert g.capacity(8192, False) == 8192       # the serving prefill
    assert g.capacity(8, False) == 8             # one decode step at B=8
    assert g.capacity(3, False) == 4             # min_capacity
    assert tmoe.GatingConfig(num_experts=3, top_k=2).capacity(5, True) == 5


def test_gather_dispatch_matches_jax():
    s, e, d, f, k = 24, 4, 8, 12, 2
    rng = np.random.RandomState(1)
    x = rng.randn(s, d).astype(np.float32)
    logits = rng.randn(s, e).astype(np.float32)
    up = rng.randn(e, d, f).astype(np.float32)
    down = rng.randn(e, f, d).astype(np.float32)
    gj = jmoe.GatingConfig(num_experts=e, top_k=k, eval_capacity_factor=1.0)
    gt = tmoe.GatingConfig(**dataclasses.asdict(gj))
    cap = gj.capacity(s, False)
    cj = jmoe.top_k_gating_compact(jnp.asarray(logits), gj, train=False)
    ct = tmoe.top_k_gating_compact(torch.tensor(logits), gt, train=False)
    assert not np.asarray(cj.kept).all()        # some choices were dropped
    yj = jmoe.moe_ffn_gather(
        jnp.asarray(x), cj, e, cap,
        lambda xe: jnp.einsum("ecf,efd->ecd",
                              jnp.tanh(jnp.einsum("ecd,edf->ecf", xe, up)), down))
    yt = tmoe.moe_ffn_gather(
        torch.tensor(x), ct, e, cap,
        lambda xe: torch.bmm(torch.tanh(torch.bmm(xe, torch.tensor(up))),
                             torch.tensor(down)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
