"""Train-mode MoE of the port against the JAX package's
`top_k_gating_compact` + `moe_ffn_gather`: capacity factor 1.5 with tokens
dropped, padding tokens, the aux loss, and the gradients of
sum(y * cotangent) + coef * aux to the tokens, the router and the expert
weights (f32, tolerance 5e-4).  The assignment itself must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llavamod_tpu.ops import moe as jmoe
from llavamod_tpu_torch.ops import moe as tmoe

torch.set_num_threads(2)
TOL = 5e-4
S, E, D, F, K, COEF = 48, 4, 8, 12, 2, 0.5


def _inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(S, D).astype(np.float32)
    x[:, 0] = 1.0                          # a constant feature ...
    router = (rng.randn(D, E) * 0.5).astype(np.float32)
    router[0] = [2.5, 1.0, 0.0, -1.0]      # ... that crowds experts 0 and 1
    gate = (rng.randn(E, D, F) * 0.3).astype(np.float32)
    up = (rng.randn(E, D, F) * 0.3).astype(np.float32)
    down = (rng.randn(E, F, D) * 0.3).astype(np.float32)
    cot = rng.randn(S, D).astype(np.float32)
    valid = np.ones((S,), bool)
    valid[:6] = False
    return x, router, gate, up, down, cot, valid


def test_train_gating_drops_and_gradients_match_jax():
    x, router, gate, up, down, cot, valid = _inputs()
    gj = jmoe.GatingConfig(num_experts=E, top_k=K, capacity_factor=1.5)
    gt = tmoe.GatingConfig(**dataclasses.asdict(gj))
    cap = gj.capacity(S, True)
    assert cap == gt.capacity(S, True) == 36 and gj.capacity(S, False) == 48

    def jexpert(p):
        return lambda xe: jnp.einsum(
            "ecf,efd->ecd", jax.nn.silu(jnp.einsum("ecd,edf->ecf", xe, p[2]))
            * jnp.einsum("ecd,edf->ecf", xe, p[3]), p[4])

    def jloss(*p):
        comp = jmoe.top_k_gating_compact(p[0] @ p[1], gj, train=True,
                                         token_valid=jnp.asarray(valid))
        y = jmoe.moe_ffn_gather(p[0], comp, E, cap, jexpert(p))
        return jnp.sum(y * cot) + COEF * comp.aux_loss, comp

    (jl, jcomp), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                         has_aux=True)(
        *map(jnp.asarray, (x, router, gate, up, down)))

    tp = [torch.tensor(a, requires_grad=True)
          for a in (x, router, gate, up, down)]
    comp = tmoe.top_k_gating_compact(tp[0] @ tp[1], gt, train=True,
                                     token_valid=torch.tensor(valid))
    y = tmoe.moe_ffn_gather(
        tp[0], comp, E, cap,
        lambda xe: torch.bmm(torch.nn.functional.silu(torch.bmm(xe, tp[2]))
                             * torch.bmm(xe, tp[3]), tp[4]))
    tl = (y * torch.tensor(cot)).sum() + COEF * comp.aux_loss
    tl.backward()

    assert not np.asarray(jcomp.kept).all()          # capacity drops happened
    for name in ("expert", "slot", "kept"):
        assert (getattr(comp, name).numpy()
                == np.asarray(getattr(jcomp, name))).all(), name
    np.testing.assert_allclose(comp.aux_loss.item(), float(jcomp.aux_loss),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL, atol=TOL)
    for t, j, name in zip(tp, jg, ("x", "router", "gate", "up", "down")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert (tp[0].grad.numpy()[~valid] == 0).all()   # padding routes nowhere


def test_aux_loss_gradient_flows_through_the_gates_only():
    """aux = mean(me * ce) * E^2, so d aux / d router is the vjp of
    me = mean(softmax(x @ router)) with ce * E: ce is a count of top-1
    choices and carries no gradient."""
    x, router = map(torch.tensor, _inputs()[:2])
    gt = tmoe.GatingConfig(num_experts=E, top_k=K)
    r = router.clone().requires_grad_()
    comp = tmoe.top_k_gating_compact(x @ r, gt, train=True)
    comp.aux_loss.backward()
    _, want = torch.autograd.functional.vjp(
        lambda rr: torch.softmax(x @ rr, -1).mean(0), router,
        comp.expert_load * E)
    torch.testing.assert_close(r.grad, want, rtol=1e-5, atol=1e-6)
