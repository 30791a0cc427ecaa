"""Trainable sets, schedules and AdamW of the port
(llavamod_tpu_torch/train/optim.py) against the JAX package's optax chain:
the trainable mask leaf for leaf, the learning-rate schedules count for
count, and three AdamW updates (warmup, cosine decay, global-norm clipping,
weight decay on rank >= 2, a separate projector LR) from the same seeded
gradients, f32, tolerance 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from util_torch_port import flatten_numpy, matched_llava, tiny_llava_config

from llavamod_tpu.train import optim as joptim
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu_torch.interop.from_jax import numpy_from_state_dict
from llavamod_tpu_torch.train import optim as toptim
from llavamod_tpu_torch.train.config import TrainConfig

RECORD = ("/gate", "/up", "/down", "router")


def _jax_mask(jparams, cfg):
    return {k: bool(v) for k, v in flatten_numpy(
        joptim.trainable_mask(jparams, JTrainConfig(**cfg))).items()}


@pytest.mark.parametrize("cfg", [
    dict(stage="align", train_modules=RECORD),
    dict(stage="pretrain", tune_mm_mlp_adapter=True),
    dict(stage="finetune"),
    dict(stage="align", train_modules=("router",), freeze_mm_mlp_adapter=True),
], ids=["record", "stage1", "full", "router-frozen-projector"])
def test_trainable_mask_matches_jax(cfg):
    _, jparams, model = matched_llava(tiny_llava_config())
    got = toptim.trainable_mask(model, TrainConfig(**cfg))
    assert got == _jax_mask(jparams, cfg)
    if cfg.get("tune_mm_mlp_adapter"):
        assert {k for k, v in got.items() if v} == {
            k for k in got if k.startswith("projector")}


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.3])
def test_schedules_match_optax(kind, warmup_ratio):
    cfg = dict(lr_schedule=kind, warmup_ratio=warmup_ratio, total_steps=10)
    want = joptim.make_lr_schedule(JTrainConfig(**cfg), 3e-4)
    got = toptim.make_lr_schedule(TrainConfig(**cfg), 3e-4)
    for c in range(12):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"count {c}")
    if warmup_ratio and kind != "constant":
        assert got(0) == 0.0     # the first update of a warmup is lr 0


def test_three_adamw_updates_match_optax():
    cfg = dict(stage="align", train_modules=RECORD, learning_rate=1e-2,
               mm_projector_lr=3e-3, weight_decay=0.1, warmup_ratio=0.2,
               total_steps=10, max_grad_norm=1.0)
    _, jparams, model = matched_llava(tiny_llava_config())
    mask = _jax_mask(jparams, cfg)
    opt = joptim.build_optimizer(jparams, JTrainConfig(**cfg))
    jstate = opt.init(jparams)
    state = toptim.TrainState.create(model, TrainConfig(**cfg))
    assert set(state.opt.params) == {k for k, v in mask.items() if v}
    assert set(state.opt.groups["projector"].params) == {
        k for k in mask if k.startswith("projector")}

    rng = np.random.RandomState(0)
    flat = flatten_numpy(jax.device_get(jparams))
    for i in range(3):
        # one update clips (norm > 1), the others do not
        scale = 0.5 if i == 1 else 0.001
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             if mask[k] else np.zeros_like(v) for k, v in flat.items()}
        updates, jstate = opt.update(_unflatten(jparams, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state.opt.update({k: torch.tensor(g[k]) for k in state.opt.params})
    want = flatten_numpy(jax.device_get(jparams))
    got = numpy_from_state_dict(model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert mask[k] or np.array_equal(got[k], flat[k]), k


def _unflatten(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix])


def test_adafactor_and_accumulation_wait():
    """Adafactor still waits (ROADMAP Queue 1, item 4); accumulation is
    ported: it wraps the optimizer in MultiSteps (held against
    optax.MultiSteps in tests/test_torch_pretrain_dpo_step.py)."""
    model = matched_llava(tiny_llava_config())[2]
    with pytest.raises(NotImplementedError):
        toptim.TrainState.create(model, TrainConfig(optimizer="adafactor"))
    state = toptim.TrainState.create(model, TrainConfig(grad_accum_steps=2))
    assert isinstance(state.opt, toptim.MultiSteps) and state.opt.k == 2
    assert set(state.opt.acc) == set(state.opt.params)
