"""The port's stage-2 distillation step (llavamod_tpu_torch/train/steps.py
`make_align_step`) against the JAX package's, 3 steps from the same weights
and batch: a tiny MoE student (experts on layer 0) and a wider dense
teacher that shares the student's frozen tower, vocab 1000 streamed in
chunks of 96, the record train set (FFN + router), AdamW with warmup,
cosine decay, clipping and weight decay, f32 compute.  Every metric per step
and every parameter after the steps agree within 1.5e-3 (ROADMAP's parity
budget).  One case runs attention through the flash path on both sides:
the JAX Pallas kernels (forward and the _dq/_dkv backward) in interpret
mode, and the port's autograd Function on its plain CPU version."""

import jax
import numpy as np
import pytest
import torch

from util_torch_port import (
    flatten_numpy,
    matched_llava,
    tiny_llava_config,
    to_jax_llava,
)

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.optim import TrainState as JTrainState
from llavamod_tpu.train.steps import (
    batch_from_arrays as jbatch_from_arrays,
    make_align_step as jmake_align_step,
)
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

TOL = 1.5e-3
STEPS = 3
VOCAB, CHUNK, T = 1000, 96, 24
METRICS = ("loss", "loss/align", "loss/lm", "loss/moe_balance", "num_tokens",
           "grad_norm")


def _batch(cfg, seed=0):
    """Row 1 is left padded by 5; one image per row right after the first
    real token; labels masked on the image slots and the first T/4."""
    rng = np.random.RandomState(seed)
    b, n_img, s = 2, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, VOCAB, (b, T)).astype(np.int32)
    seg = np.ones((b, T), np.int32)
    seg[1, :5] = 0
    ids[1, :5] = 0
    im = np.zeros((b, T), bool)
    ip = np.zeros((b, T), np.int32)
    for i, st in enumerate((1, 6)):
        im[i, st:st + n_img] = True
        ip[i, st:st + n_img] = i * n_img + np.arange(n_img)
    labels = np.where(im | (seg == 0), -100, ids)
    labels[:, :T // 4] = -100
    return {"input_ids": ids, "segment_ids": seg, "image_mask": im,
            "image_pos": ip,
            "pixels": rng.randn(b, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((b, 1), bool), "labels": labels}


def _setup(attn_impl):
    student = tiny_llava_config(vocab_size=VOCAB)
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", hidden_size=96, intermediate_size=160,
        num_heads=4, num_kv_heads=4, num_layers=2, moe_num_experts=0,
        moe_layers=()))
    _, jparams, model = matched_llava(student, seed=0)
    jteacher = jllava.init(to_jax_llava(teacher), jax.random.PRNGKey(7))
    jteacher = {k: v for k, v in jteacher.items() if k != "vision"}
    tmodel = tllava.init(teacher, torch.Generator().manual_seed(7),
                         vision=False)
    load_jax_params(tmodel, jax.device_get(jteacher))
    return student, teacher, jparams, model, jteacher, tmodel


@pytest.mark.parametrize("loss_type,remat,attn_impl", [
    ("kd_lm", False, "xla"), ("only_kd", True, "xla"),
    ("kd_lm", True, "flash")], ids=["kd_lm", "only_kd-remat", "kd_lm-flash"])
def test_align_step_matches_jax(loss_type, remat, attn_impl):
    student, teacher, jparams, model, jteacher, tmodel = _setup(attn_impl)
    kw = dict(stage="align", align_loss_type=loss_type, remat=remat,
              compute_dtype="float32", param_dtype="float32",
              vocab_chunk=CHUNK, attn_impl=attn_impl, learning_rate=5e-4,
              weight_decay=0.1, warmup_ratio=0.2, total_steps=10,
              max_grad_norm=1.0,
              train_modules=("/gate", "/up", "/down", "router"))
    arrays = _batch(student)
    init = flatten_numpy(jax.device_get(jparams))

    jstep = jmake_align_step(to_jax_llava(student), to_jax_llava(teacher),
                             JTrainConfig(**kw))
    jstate = JTrainState.create(jparams, JTrainConfig(**kw))
    jb = jbatch_from_arrays(arrays)
    step = make_align_step(student, teacher, TrainConfig(**kw))
    state = TrainState.create(model, TrainConfig(**kw))
    tb = batch_from_arrays(arrays, device="cpu")

    for i in range(STEPS):
        jstate, jm = jstep(jstate, jteacher, jb)
        state, m = step(state, tmodel, tb)
        for name in METRICS:
            if name == "loss/lm" and loss_type != "kd_lm":
                assert name not in m
                continue
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {i} {name}")
    assert state.step == STEPS
    want = flatten_numpy(jax.device_get(jstate.params))
    got = numpy_from_state_dict(state.model)
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL,
                                   err_msg=key)
    moved = {k for k in want if not np.array_equal(want[k], init[k])}
    assert "llm.layers.0.mlp.router" in moved
    assert not any(k.startswith("vision") or ".attn." in k for k in moved)


def test_frozen_parameters_take_no_gradient_and_do_not_move():
    student, teacher, jparams, model, jteacher, tmodel = _setup("xla")
    tcfg = TrainConfig(stage="align", align_loss_type="kd_lm",
                       compute_dtype="float32", vocab_chunk=CHUNK,
                       learning_rate=1e-3, warmup_ratio=0.0,
                       train_modules=("router",))
    before = numpy_from_state_dict(model)
    state = TrainState.create(model, tcfg)
    state, m = make_align_step(student, teacher, tcfg)(
        state, tmodel, batch_from_arrays(_batch(student), device="cpu"))
    after = numpy_from_state_dict(state.model)
    changed = {k for k in before if not np.array_equal(before[k], after[k])}
    assert changed == {"llm.layers.0.mlp.router", "projector.layers.0.kernel",
                       "projector.layers.0.bias", "projector.layers.1.kernel",
                       "projector.layers.1.bias"}
    assert all(p.grad is None for p in state.model.parameters())
    assert np.isfinite(m["loss"].item())


def test_f32_masters_with_bf16_compute():
    """param_dtype f32, compute_dtype bf16: the forward reads bf16 casts of
    the f32 parameters (remat recomputes with the same casts), gradients
    come back to the f32 masters, and the metrics stay within bf16 rounding
    (2e-2) of the all-f32 step."""
    student, teacher, _, model, _, tmodel = _setup("xla")
    kw = dict(stage="align", align_loss_type="kd_lm", vocab_chunk=CHUNK,
              learning_rate=1e-3, warmup_ratio=0.0, remat=True,
              train_modules=("/gate", "/up", "/down", "router"))
    batch = batch_from_arrays(_batch(student), device="cpu")
    before = numpy_from_state_dict(model)
    ref_model = _setup("xla")[3]
    _, want = make_align_step(student, teacher, TrainConfig(
        compute_dtype="float32", **kw))(
        TrainState.create(ref_model, TrainConfig(**kw)), tmodel, batch)
    state, got = make_align_step(student, teacher, TrainConfig(
        compute_dtype="bfloat16", **kw))(
        TrainState.create(model, TrainConfig(**kw)), tmodel, batch)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    for name in ("loss", "loss/align", "loss/lm", "grad_norm"):
        np.testing.assert_allclose(got[name].item(), want[name].item(),
                                   rtol=2e-2, err_msg=name)
    after = numpy_from_state_dict(state.model)
    assert not np.array_equal(after["llm.layers.1.mlp.up"],
                              before["llm.layers.1.mlp.up"])
    assert np.array_equal(after["llm.layers.1.attn.wq"],
                          before["llm.layers.1.attn.wq"])
