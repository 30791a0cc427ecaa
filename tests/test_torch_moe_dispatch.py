"""The MoE dispatch variants and recomputation policies of the port
(llavamod_tpu_torch/ops/moe.py, models/llm/decoder.py) against the JAX
package, f32, tolerance 1e-5 unless stated:

  * the assignment of batched (per-group) gating, in index and in one-hot
    form, identical to the JAX package's vmapped gating (expert, slot,
    kept, dispatch exactly);
  * `moe_block_forward` with 'gather', 'ragged' and 'einsum' dispatch,
    global and grouped gating (drops, padding tokens, a group count that
    needs padding): output, aux loss, router probabilities, and the
    gradients of the tokens, the router and the experts;
  * the group-padding cases of tests/test_moe_group_pad.py: the grouped
    path is taken, padding equals explicit invalid tokens (exactly), and
    gradients flow;
  * `ragged_dense_int8`: the forward and the straight-through dL/dx
    against the JAX custom_vjp (int32 products exact; 1e-6 after the f32
    rescale);
  * `remat_policy` 'moe' and 'dots' give the loss and gradients of 'none'
    (the recomputation repeats the same operations: 1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_torch_port import np32, to_jax_llm

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.ops import moe as jmoe
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.ops import moe as tmoe

torch.set_num_threads(2)
TOL = 1e-5


def _moe_cfg(**kw):
    base = dict(moe_num_experts=4, moe_top_k=2, moe_layers=(0, 1),
                moe_capacity_factor=1.0)
    base.update(kw)
    return tiny_config(**base)


def _matched(cfg, seed=0):
    """(JAX params, port Decoder) with the same weights; routers seeded
    non-zero so the top-2 choice and the drops are exercised."""
    jp = jax.device_get(jdecoder.init(to_jax_llm(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 1)
    for layer in jp["layers"]:
        if "router" in layer["mlp"]:
            layer["mlp"]["router"] = rng.randn(
                *layer["mlp"]["router"].shape).astype(np.float32)
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jp)
    return jp, model


def _logits(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[..., :3, :] = np.round(x[..., :3, :])        # ties
    return x


def test_batched_gating_assignment_is_identical():
    g, s, e = 3, 16, 4
    logits = _logits((g, s, e), 0)
    valid = np.ones((g, s), bool)
    valid[1, :5] = False
    gj = jmoe.GatingConfig(num_experts=e, top_k=2, capacity_factor=1.0,
                           min_capacity=2)
    gt = tmoe.GatingConfig(**dataclasses.asdict(gj))
    cj = jax.vmap(lambda lg, v: jmoe.top_k_gating_compact(
        lg, gj, train=True, token_valid=v))(jnp.asarray(logits),
                                            jnp.asarray(valid))
    ct = tmoe.top_k_gating_compact(torch.tensor(logits), gt, train=True,
                                   token_valid=torch.tensor(valid))
    for name in ("expert", "slot", "kept"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), name)
    assert not ct.kept.all()                        # some choices dropped
    for name in ("weight", "aux_loss", "expert_load", "router_probs"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)

    oj = jax.vmap(lambda lg, v: jmoe.top_k_gating(
        lg, gj, train=True, token_valid=v))(jnp.asarray(logits),
                                            jnp.asarray(valid))
    ot = tmoe.top_k_gating(torch.tensor(logits), gt, train=True,
                           token_valid=torch.tensor(valid))
    np.testing.assert_array_equal(ot.dispatch.numpy(), np.asarray(oj.dispatch))
    for name in ("combine", "aux_loss", "expert_load", "router_probs"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _block_loss_and_grads_jax(cfg, mlp, x, valid, r):
    """JAX block outputs and the gradients of sum(y * r) + aux wrt the
    float leaves of `mlp` (int8 leaves held fixed) and x."""
    jcfg = to_jax_llm(cfg)
    mlp = jax.tree_util.tree_map(jnp.asarray, mlp)
    is_float = lambda a: jnp.issubdtype(a.dtype, jnp.floating)  # noqa: E731
    fixed = jax.tree_util.tree_map(lambda a: None if is_float(a) else a, mlp)
    free = jax.tree_util.tree_map(lambda a: a if is_float(a) else None, mlp)

    @jax.jit
    def loss(free, x):
        full = jax.tree_util.tree_map(lambda f, c: c if f is None else f,
                                      free, fixed,
                                      is_leaf=lambda a: a is None)
        y, aux, probs = jdecoder.moe_block_forward(
            jcfg, full, x, True, None if valid is None else jnp.asarray(valid))
        return jnp.sum(y * r) + aux, (y, aux, probs)

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        free, jnp.asarray(x))
    return out, grads


@pytest.mark.parametrize("dispatch", ["gather", "ragged", "einsum"])
@pytest.mark.parametrize("group,tokens", [(0, (2, 16)), (16, (2, 16)),
                                          (16, (1, 24))],
                         ids=["global", "groups", "groups-padded"])
def test_moe_block_matches_jax(dispatch, group, tokens):
    cfg = _moe_cfg(moe_dispatch=dispatch, moe_gating_group_size=group)
    jp, model = _matched(cfg)
    rng = np.random.RandomState(2)
    x = rng.randn(*tokens, cfg.hidden_size).astype(np.float32)
    r = rng.randn(*tokens, cfg.hidden_size).astype(np.float32)
    valid = np.ones(tokens, bool)
    valid[0, :3] = False
    (y_j, aux_j, probs_j), (g_mlp, g_x) = _block_loss_and_grads_jax(
        cfg, jp["layers"][0]["mlp"], x, valid, r)

    mlp = model.layers[0].mlp
    xt = torch.tensor(x, requires_grad=True)
    y, aux, probs = tdecoder.moe_block_forward(cfg, mlp, xt, True,
                                               torch.tensor(valid))
    ((y * torch.tensor(r)).sum() + aux).backward()
    for name, got, want in (("y", y, y_j), ("aux", aux, aux_j),
                            ("probs", probs, probs_j), ("dx", xt.grad, g_x),
                            ("router", mlp.router.grad, g_mlp["router"])):
        np.testing.assert_allclose(np32(got), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for name, p in mlp.experts.named_parameters():
        np.testing.assert_allclose(np32(p.grad),
                                   np.asarray(g_mlp["experts"][name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert np.abs(np.asarray(g_mlp["router"])).max() > 0


def test_unknown_dispatch_raises():
    cfg = _moe_cfg(moe_dispatch="scatter")
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="moe_dispatch"):
        tdecoder.moe_block_forward(cfg, model.layers[0].mlp,
                                   torch.zeros(1, 4, cfg.hidden_size), True,
                                   None)


@pytest.mark.parametrize("dispatch", ["gather", "ragged", "einsum"])
def test_indivisible_tokens_use_grouped_gating(monkeypatch, dispatch):
    cfg = _moe_cfg(moe_dispatch=dispatch, moe_gating_group_size=16)
    _, model = _matched(cfg)
    name = "top_k_gating" if dispatch == "einsum" else "top_k_gating_compact"
    seen, orig = [], getattr(tdecoder, name)

    def spy(logits, *a, **kw):
        seen.append(tuple(logits.shape))
        return orig(logits, *a, **kw)

    monkeypatch.setattr(tdecoder, name, spy)
    x = torch.randn(1, 24, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(2))
    y, aux, probs = tdecoder.moe_block_forward(cfg, model.layers[0].mlp, x,
                                               True, None)
    assert y.shape == x.shape and probs.shape[0] == 24
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    # 24 tokens, group 16 -> padded to 2 groups of 16, gated per group
    assert seen == [(2, 16, cfg.moe_num_experts)], seen


@pytest.mark.parametrize("dispatch", ["gather", "ragged", "einsum"])
def test_group_padding_matches_explicit_padding(dispatch):
    cfg = _moe_cfg(moe_dispatch=dispatch, moe_gating_group_size=16)
    _, model = _matched(cfg)
    mlp = model.layers[0].mlp
    x = torch.randn(1, 24, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        y_auto, aux_auto, _ = tdecoder.moe_block_forward(cfg, mlp, x, True,
                                                         None)
        x_pad = torch.nn.functional.pad(x, (0, 0, 0, 8))
        valid = torch.arange(32)[None, :] < 24
        y_exp, aux_exp, _ = tdecoder.moe_block_forward(cfg, mlp, x_pad, True,
                                                       valid)
    torch.testing.assert_close(y_auto, y_exp[:, :24], rtol=0, atol=0)
    torch.testing.assert_close(aux_auto, aux_exp, rtol=0, atol=0)


def test_group_padding_gradients_flow():
    cfg = _moe_cfg(moe_dispatch="gather", moe_gating_group_size=16)
    _, model = _matched(cfg)
    mlp = model.layers[0].mlp
    x = torch.randn(1, 24, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(4))
    y, aux, _ = tdecoder.moe_block_forward(cfg, mlp, x, True, None)
    ((y ** 2).sum() + aux).backward()
    grads = [p.grad for p in mlp.parameters()]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def test_ragged_dense_int8_and_its_straight_through_dx_match_jax():
    rng = np.random.RandomState(5)
    e, d, f, m = 4, 64, 48, 24
    sizes = np.array([5, 0, 9, 3], np.int32)          # 17 rows, 7 past them
    xr = rng.randn(m, d).astype(np.float32)
    xr[sizes.sum():] = 0.0
    w = rng.randint(-127, 128, (e, d, f)).astype(np.int8)
    scale = (rng.rand(e, f) * 0.02 + 1e-3).astype(np.float32)
    g = rng.randn(m, f).astype(np.float32)

    y_j, vjp = jax.vjp(lambda x: jdecoder.ragged_dense_int8(
        x, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(sizes)),
        jnp.asarray(xr))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(xr, requires_grad=True)
    y = tdecoder.ragged_dense_int8(xt, torch.tensor(w), torch.tensor(scale),
                                   torch.tensor(sizes))
    y.backward(torch.tensor(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-6, atol=1e-6)
    assert not y[sizes.sum():].any()


def test_int8_ragged_experts_match_jax():
    """The ragged dispatch over int8 experts (quantize_decoder_int8 with
    include_experts) against the JAX block: output and the router's
    gradient, which reaches it only through the straight-through dx."""
    cfg = _moe_cfg(moe_dispatch="ragged", moe_gating_group_size=16)
    jp, model = _matched(cfg)
    jq = jax.device_get(jdecoder.quantize_decoder_int8(
        jax.tree_util.tree_map(jnp.asarray, jp), include_experts=True))
    tdecoder.quantize_decoder_int8(model, include_experts=True)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, cfg.hidden_size).astype(np.float32)
    r = rng.randn(2, 16, cfg.hidden_size).astype(np.float32)
    (y_j, aux_j, _), (g_mlp, _) = _block_loss_and_grads_jax(
        cfg, jq["layers"][0]["mlp"], x, None, r)
    mlp = model.layers[0].mlp
    y, aux, _ = tdecoder.moe_block_forward(cfg, mlp, torch.tensor(x), True,
                                           None)
    ((y * torch.tensor(r)).sum() + aux).backward()
    np.testing.assert_allclose(np32(y), np.asarray(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(mlp.router.grad),
                               np.asarray(g_mlp["router"]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("policy,remat", [("moe", False), ("dots", True)])
def test_remat_policies_give_the_gradients_of_none(policy, remat):
    cfg = _moe_cfg(moe_layers=(0,), num_layers=2, moe_gating_group_size=16)
    _, model = _matched(cfg)
    ids = torch.tensor(np.random.RandomState(7).randint(
        1, cfg.vocab_size, (2, 16)))
    r = torch.randn(2, 16, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(8))

    def run(c, rm):
        model.zero_grad(set_to_none=True)
        out = tdecoder.forward(model, c, input_ids=ids, train=True, remat=rm)
        loss = (out.hidden * r).sum() + out.aux_loss
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()
                               if p.grad is not None}   # the head is unused

    want_loss, want = run(cfg, False)
    got_loss, got = run(cfg.replace(remat_policy=policy), remat)
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-6, atol=1e-6)
    assert got.keys() == want.keys() and "layers.0.mlp.router" in want
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-6,
                                   msg=n)
