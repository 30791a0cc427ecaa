"""Adafactor of the port (llavamod_tpu_torch/train/adafactor.py and the
`Adafactor` groups of train/optim.py) against the JAX package:

  * the leaf rule against optax.adafactor and against the JAX package's
    `update_leaf`, 3 steps at factored, unfactored and tied shapes, f32,
    tolerance 1e-5 relative + 1e-6 absolute;
  * the standard path (`Optimizer` of Adafactor groups in MultiSteps, the
    projector at its own learning rate) against the JAX `build_optimizer`
    on an unstacked tree from the same seeded gradients, parameters and
    factored statistics leaf for leaf (read through interop
    `adafactor_state_from_jax`), f32, 1e-5 + 1e-6;
  * the per-matrix blocks, pinned: on a tree whose layers are pre-stacked
    the JAX update of a layer-0 matrix moves by its stack's rms, not its
    own, so it differs from the port's by far more than the tolerance;
  * `make_align_step` with Adafactor against the JAX step, 2 microbatches
    through MultiSteps, f32, tolerance 1e-4 (the test_torch_train_step
    comparison's rounding, one update)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from util_torch_port import (
    flatten_numpy,
    matched_llava,
    multimodal_arrays,
    tiny_llava_config,
    to_jax_llava,
)

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.train import adafactor as jadafactor
from llavamod_tpu.train import optim as joptim
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.steps import batch_from_arrays as jbatch_from_arrays
from llavamod_tpu.train.steps import make_align_step as jmake_align_step
from llavamod_tpu_torch.interop.from_jax import (
    adafactor_state_from_jax,
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.train import adafactor
from llavamod_tpu_torch.train import optim as toptim
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

RTOL, ATOL = 1e-5, 1e-6
RECORD = ("/gate", "/up", "/down", "router")


@pytest.mark.parametrize("shape", [(256, 320), (300,), (256, 130, 4),
                                   (256, 256), (4, 128, 200)])
def test_update_leaf_matches_optax_and_jax(shape):
    rng = np.random.RandomState(0)
    p0 = rng.randn(*shape).astype(np.float32)
    opt = optax.adafactor(learning_rate=0.01)
    p_opt = jnp.asarray(p0)
    st = opt.init(p_opt)
    opt_step = jax.jit(lambda g, st, p: (lambda u, s: (
        optax.apply_updates(p, u), s))(*opt.update(g, st, p)))
    leaf_step = jax.jit(jadafactor.update_leaf)
    p_jax, s_jax = jnp.asarray(p0), jadafactor.init_leaf(jnp.asarray(p0))
    p, s = torch.tensor(p0), adafactor.init_leaf(torch.tensor(p0))
    assert {k: tuple(v.shape) for k, v in s.items()} == {
        k: tuple(v.shape) for k, v in s_jax.items()}
    for step in range(3):
        g = rng.randn(*shape).astype(np.float32)
        p_opt, st = opt_step(jnp.asarray(g), st, p_opt)
        p_jax, s_jax = leaf_step(p_jax, jnp.asarray(g), s_jax,
                                 jnp.asarray(step), jnp.asarray(0.01))
        p, s = adafactor.update_leaf(p, torch.tensor(g), s, step, 0.01)
        for want in (p_opt, p_jax):
            np.testing.assert_allclose(p.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}")
        for k, v in s.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(s_jax[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def _wide_config(**kw):
    """Widths of 128 and more, so the matrices are factored."""
    base = dict(hidden_size=128, intermediate_size=256, num_heads=4,
                num_kv_heads=2)
    base.update(kw)
    return tiny_llava_config(**base)


def _seeded_grads(flat, mask, rng, scale=1e-2):
    return {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            if mask[k] else np.zeros_like(v) for k, v in flat.items()}


def _unflatten(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix])


def _factored_states(opt_state):
    """The optax FactoredState of each label group of a MultiSteps(chain(
    multi_transform)) state."""
    inner = opt_state.inner_opt_state[0].inner_states
    return {lab: inner[lab].inner_state[0] for lab in ("default", "projector")}


def test_multisteps_adafactor_matches_optax_on_an_unstacked_tree():
    cfg = dict(stage="align", train_modules=RECORD, optimizer="adafactor",
               learning_rate=1e-2, mm_projector_lr=3e-3, warmup_ratio=0.2,
               total_steps=10, max_grad_norm=1.0, grad_accum_steps=2)
    _, jparams, model = matched_llava(_wide_config())
    jmask = flatten_numpy(joptim.trainable_mask(jparams, JTrainConfig(**cfg)))
    mask = {k: bool(v) for k, v in jmask.items()}
    opt = joptim.build_optimizer(jparams, JTrainConfig(**cfg))
    jstate = opt.init(jparams)
    jupdate = jax.jit(lambda g, st, p: (lambda u, s: (
        optax.apply_updates(p, u), s))(*opt.update(g, st, p)))
    state = toptim.TrainState.create(model, TrainConfig(**cfg))
    group = state.opt.inner.groups["default"]
    assert isinstance(group, toptim.Adafactor)
    assert group.state["llm.layers.0.mlp.experts.up"].keys() == {"v_row",
                                                                 "v_col"}

    rng = np.random.RandomState(0)
    flat = flatten_numpy(jax.device_get(jparams))
    for i in range(6):       # 3 updates: warmup (lr 0), then lr > 0
        # one microbatch with gradients large enough to clip the update
        g = _seeded_grads(flat, mask, rng, scale=3.0 if i == 2 else 1e-2)
        jparams, jstate = jupdate(_unflatten(jparams, g), jstate, jparams)
        state.opt.update({k: torch.tensor(g[k]) for k in state.opt.params})
    assert state.opt.updates == 3
    want = flatten_numpy(jax.device_get(jparams))
    got = numpy_from_state_dict(model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert mask[k] or np.array_equal(got[k], flat[k]), k
    assert not np.array_equal(got["llm.layers.0.mlp.experts.up"],
                              flat["llm.layers.0.mlp.experts.up"])
    for lab, fs in _factored_states(jax.device_get(jstate)).items():
        jst = adafactor_state_from_jax(fs)
        mine = state.opt.inner.groups[lab].state
        assert jst.keys() == mine.keys(), lab
        for k, leaf in jst.items():
            for name, v in leaf.items():
                np.testing.assert_allclose(mine[k][name].numpy(), v.numpy(),
                                           rtol=RTOL, atol=1e-12,
                                           err_msg=f"{k} {name}")
    # the factored statistics round-trip through the state dict
    sd = state.opt.state_dict()
    again = toptim.TrainState.create(model, TrainConfig(**cfg))
    again.opt.load_state_dict(sd)
    assert again.opt.updates == 3
    v = again.opt.inner.groups["default"].state["llm.layers.0.mlp.router"]
    assert torch.equal(v["v"], group.state["llm.layers.0.mlp.router"]["v"])


def test_blocks_are_per_matrix_unlike_the_jax_stacked_tree():
    """Layers 0 and 2 are one structural period apart; the JAX trainer's
    pre-stacked tree holds them as one [2, ...] leaf, which optax's update
    clipping and parameter scale treat as one block.  With layer 2's
    experts 10x larger, layer 0's update in the stacked tree is ~7x the
    per-matrix one.  The port equals the unstacked JAX update."""
    cfg = dict(stage="align", train_modules=RECORD, optimizer="adafactor",
               learning_rate=1e-2, warmup_ratio=0.0, lr_schedule="constant",
               total_steps=10)
    lcfg = _wide_config(num_layers=4, moe_layers=(0, 2))
    jcfg = to_jax_llava(lcfg)
    jparams = jax.device_get(jllava.init(jcfg, jax.random.PRNGKey(0)))
    up2 = jparams["llm"]["layers"][2]["mlp"]["experts"]
    for name in list(up2):
        up2[name] = up2[name] * 10.0
    model = tllava.init(lcfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jparams)
    key = "llm.layers.0.mlp.experts.up"

    jmask = flatten_numpy(joptim.trainable_mask(jparams, JTrainConfig(**cfg)))
    mask = {k: bool(v) for k, v in jmask.items()}
    flat = flatten_numpy(jparams)
    g = _seeded_grads(flat, mask, np.random.RandomState(1))
    gtree = _unflatten(jparams, g)

    @jax.jit
    def jax_update(params, grads):
        opt = joptim.build_optimizer(params, JTrainConfig(**cfg))
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    unstacked = flatten_numpy(jax.device_get(jax_update(jparams, gtree)))
    stack = lambda tree: dict(tree, llm=jdecoder.stack_layers(  # noqa: E731
        jcfg.llm, tree["llm"]))
    new = jax.device_get(jax_update(stack(jparams), stack(gtree)))
    new["llm"] = jdecoder.unstack_layers(jcfg.llm, new["llm"])
    stacked = flatten_numpy(new)

    state = toptim.TrainState.create(model, TrainConfig(**cfg))
    state.opt.update({k: torch.tensor(g[k]) for k in state.opt.params})
    got = numpy_from_state_dict(model)[key]
    np.testing.assert_allclose(got, unstacked[key], rtol=RTOL, atol=ATOL)
    moved = np.abs(got - flat[key]).max()
    assert np.abs(stacked[key] - got).max() > 3 * moved > 1e3 * ATOL


def test_align_step_with_adafactor_matches_jax():
    student = _wide_config(vocab_size=512)
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", moe_num_experts=0, moe_layers=()))
    jcfg, jparams, model = matched_llava(student)
    jteacher = jllava.init(to_jax_llava(teacher), jax.random.PRNGKey(7))
    tteacher = tllava.init(teacher, torch.Generator().manual_seed(0))
    load_jax_params(tteacher, jax.device_get(jteacher))
    kw = dict(stage="align", align_loss_type="kd_lm", optimizer="adafactor",
              remat=False, compute_dtype="float32", param_dtype="float32",
              vocab_chunk=128, attn_impl="xla", learning_rate=1e-2,
              lr_schedule="constant", warmup_ratio=0.0, total_steps=10,
              grad_accum_steps=2, train_modules=RECORD)
    jstep = jmake_align_step(jcfg, to_jax_llava(teacher), JTrainConfig(**kw))
    jstate = joptim.TrainState.create(jparams, JTrainConfig(**kw))
    step = make_align_step(student, teacher, TrainConfig(**kw))
    state = toptim.TrainState.create(model, TrainConfig(**kw))
    for i in range(4):
        arrays = multimodal_arrays(student, [16, 12], 16, seed=i)
        arrays["labels"] = np.where(arrays["image_mask"], -100,
                                    arrays["input_ids"])
        jstate, jm = jstep(jstate, jteacher, jbatch_from_arrays(arrays))
        state, m = step(state, tteacher, batch_from_arrays(arrays,
                                                           device="cpu"))
        for k in ("loss", "loss/align", "loss/lm", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"microbatch {i} {k}")
    assert state.opt.updates == 2
    want = flatten_numpy(jax.device_get(jstate.params))
    got = numpy_from_state_dict(model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
