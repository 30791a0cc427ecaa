"""The fused backward+update align step of the port
(llavamod_tpu_torch/train/fused_steps.py) on the CPU, f32:

  * one fused step equals the port's standard path (`make_align_step` +
    Adafactor) for 1 and 2 structural periods and each `fused_remat`:
    metrics rel 1e-6, parameters 1e-6 abs (the same operations, summed in
    another order);
  * folded accumulation (2 microbatches in one batch) with gating groups
    that tile the microbatch, tokens dropped, equals MultiSteps fed the
    two microbatches: loss = the mean of theirs, parameters 1e-6;
  * global gating with accumulation warns and takes the folded backward:
    'repeat' equals 'save_all' (the forward's own graph), and grouped
    gating routes differently on the same data (the case is not vacuous);
  * a trainable embedding, head and final norm, tied and untied: 3 steps
    against the standard path, 1e-5;
  * the refusals: an int8 head that trains, AdamW, a parameter stored off
    the compute dtype;
  * the teacher / forward / backward chunk settings give one result;
  * against the JAX package's `make_fused_align_step` itself (its tree
    pre-stacked and unstacked in the test), folded accumulation with
    gating groups: metrics 1e-5 rel, parameters 1e-5;
  * `fold_microbatches` equals the JAX copy's output exactly, and both
    refuse a dangling microbatch."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from util_torch_port import flatten_numpy, randomize_routers, to_jax_llava

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.train import fused_steps as jfused
from llavamod_tpu.train import loader as jloader
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.steps import batch_from_arrays as jbatch_from_arrays
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.llava import LlavaConfig
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.vision.vit import tiny_vision_config
from llavamod_tpu_torch.train import loader as tloader
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.fused_steps import (
    init_fused_state,
    make_fused_align_step,
)
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

torch.set_num_threads(2)
RECORD = ("/gate", "/up", "/down", "router")


def _configs(reps=2, group=0, capacity=1.5, tie=False):
    """A tiny MoE student (reps structural periods: experts on layer 1 of
    2, or on every 2nd of 4) and its dense teacher."""
    llm = tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_layers=2 * reps, num_heads=4, num_kv_heads=2,
                      moe_num_experts=4, moe_top_k=2,
                      moe_layers=(1,) if reps == 1 else (0, 2),
                      moe_capacity_factor=capacity,
                      moe_gating_group_size=group, tie_word_embeddings=tie)
    cfg = LlavaConfig(llm=llm, vision=tiny_vision_config(),
                      projector_type="mlp2x_gelu", max_images=1)
    return cfg, cfg.replace(llm=llm.replace(moe_num_experts=0, moe_layers=()))


def _models(cfg, teacher_cfg):
    student = tllava.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for layer in student.llm.layers:
            if layer.is_moe:
                layer.mlp.router.copy_(torch.randn(layer.mlp.router.shape,
                                                   generator=gen))
    teacher = tllava.init(teacher_cfg, torch.Generator().manual_seed(1),
                          vision=False)
    teacher.requires_grad_(False)
    return student, teacher


def _arrays(cfg, seed, b=2, t=16):
    rng = np.random.RandomState(seed)
    n_img, s = cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, 500, size=(b, t)).astype(np.int32)
    im = np.zeros((b, t), bool)
    im[:, 1:1 + n_img] = True
    ip = np.zeros((b, t), np.int32)
    for i in range(b):
        ip[i, 1:1 + n_img] = i * n_img + np.arange(n_img)
    return {"input_ids": ids, "segment_ids": np.ones((b, t), np.int32),
            "image_mask": im, "image_pos": ip,
            "pixels": rng.randn(b, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((b, 1), bool),
            "labels": np.where(im, -100, ids)}


def _tcfg(**kw):
    base = dict(stage="align", align_loss_type="kd_lm", optimizer="adafactor",
                learning_rate=1e-2, lr_schedule="constant", warmup_ratio=0.0,
                train_modules=RECORD, total_steps=100, remat=False,
                vocab_chunk=256, kd_vocab_limit=512, compute_dtype="float32",
                attn_impl="xla")
    base.update(kw)
    return TrainConfig(**base)


def _batch(arrays):
    return batch_from_arrays(arrays, device="cpu")


def _fold(cfg, *arrays):
    (folded,) = list(tloader.fold_microbatches(
        iter(arrays), len(arrays), rows_per_sample=cfg.num_image_tokens))
    return folded


def _standard(cfg, teacher_cfg, tcfg, batches):
    student, teacher = _models(cfg, teacher_cfg)
    state = TrainState.create(student, tcfg)
    step = make_align_step(cfg, teacher_cfg, tcfg)
    metrics = []
    for b in batches:
        state, m = step(state, teacher, _batch(b))
        metrics.append({k: v.item() for k, v in m.items()})
    return student, metrics


def _fused(cfg, teacher_cfg, tcfg, batches):
    student, teacher = _models(cfg, teacher_cfg)
    state = init_fused_state(student, cfg, tcfg)
    step = make_fused_align_step(cfg, teacher_cfg, tcfg)
    metrics = []
    for b in batches:
        state, m = step(state, teacher, _batch(b))
        metrics.append({k: v.item() for k, v in m.items()})
    assert state.opt.updates == state.step == len(batches)
    return student, metrics


def _assert_params(a, b, atol, moved_from=None):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=atol, msg=k)
    if moved_from is not None:
        s0 = moved_from.state_dict()
        assert any(not torch.equal(s0[k], sa[k]) for k in sa
                   if ".experts." in k)


@pytest.mark.parametrize("reps,fused_remat", [
    (1, "repeat"), (2, "repeat"), (2, "save_dots"), (2, "save_all")])
def test_fused_step_matches_the_standard_adafactor_path(reps, fused_remat):
    cfg, tc = _configs(reps)
    tcfg = _tcfg(fused_remat=fused_remat)
    batches = [_arrays(cfg, 3)]
    std, m_std = _standard(cfg, tc, tcfg, batches)
    fused, m_f = _fused(cfg, tc, tcfg, batches)
    for k, v in m_std[0].items():
        np.testing.assert_allclose(m_f[0][k], v, rtol=1e-6, err_msg=k)
    _assert_params(fused, std, 1e-6, moved_from=_models(cfg, tc)[0])


@pytest.mark.parametrize("reps,fused_remat", [
    (1, "repeat"), (2, "repeat"), (2, "save_all")])
def test_folded_accumulation_with_groups_matches_multisteps(reps,
                                                            fused_remat):
    cfg, tc = _configs(reps, group=16, capacity=1.0)     # drops tokens
    tcfg = _tcfg(grad_accum_steps=2, fused_remat=fused_remat)
    d1, d2 = _arrays(cfg, 3), _arrays(cfg, 11)
    std, (m1, m2) = _standard(cfg, tc, tcfg, [d1, d2])
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # groups tile: no warning
        fused, (mf,) = _fused(cfg, tc, tcfg, [_fold(cfg, d1, d2)])
    np.testing.assert_allclose(mf["loss"], (m1["loss"] + m2["loss"]) / 2,
                               rtol=1e-6)
    assert mf["num_tokens"] == m1["num_tokens"] + m2["num_tokens"]
    _assert_params(fused, std, 1e-6, moved_from=_models(cfg, tc)[0])


def test_global_gating_warns_and_takes_the_folded_backward():
    cfg, tc = _configs(2, capacity=1.0)
    tcfg = _tcfg(grad_accum_steps=2)
    folded = _fold(cfg, _arrays(cfg, 3), _arrays(cfg, 11))
    with pytest.warns(UserWarning, match="global gating"):
        rep, (m_rep,) = _fused(cfg, tc, tcfg, [folded])
    with pytest.warns(UserWarning, match="global gating"):
        full, (m_all,) = _fused(cfg, tc,
                                tcfg.replace(fused_remat="save_all"), [folded])
    for k, v in m_all.items():
        np.testing.assert_allclose(m_rep[k], v, rtol=1e-6, err_msg=k)
    _assert_params(rep, full, 1e-6)
    cfg_g, _ = _configs(2, group=16, capacity=1.0)
    _, (m_grp,) = _fused(cfg_g, tc, tcfg, [folded])
    assert abs(m_grp["loss"] - m_rep["loss"]) > 1e-6


@pytest.mark.parametrize("tie", [False, True])
def test_trains_embed_head_and_final_norm(tie):
    mods = RECORD + ("embed", "final_norm") + (() if tie else ("lm_head",))
    cfg, tc = _configs(2, tie=tie)
    tcfg = _tcfg(train_modules=mods)
    batches = [_arrays(cfg, 3 + i) for i in range(3)]
    std, m_std = _standard(cfg, tc, tcfg, batches)
    fused, m_f = _fused(cfg, tc, tcfg, batches)
    for k, v in m_std[-1].items():
        np.testing.assert_allclose(m_f[-1][k], v, rtol=1e-5, err_msg=k)
    _assert_params(fused, std, 1e-5)
    s0 = _models(cfg, tc)[0].state_dict()
    moved = {k for k, v in fused.state_dict().items()
             if not torch.equal(v, s0[k])}
    assert {"llm.embed.embedding", "llm.final_norm.weight"} <= moved
    assert tie or "llm.lm_head.weight" in moved


@pytest.mark.parametrize("change,match", [
    (dict(student_head_quant=True, train_modules=("/gate", "lm_head")),
     "int8"),
    (dict(optimizer="adamw"), "adafactor"),
    (dict(compute_dtype="bfloat16"), "compute dtype"),
], ids=["int8-head", "adamw", "dtype"])
def test_refusals(change, match):
    cfg, tc = _configs(1)
    student, _ = _models(cfg, tc)
    with pytest.raises(ValueError, match=match):
        init_fused_state(student, cfg, _tcfg(**change))


def test_chunk_settings_give_one_result():
    cfg, tc = _configs(2, group=16, capacity=1.0)
    folded = _fold(cfg, *[_arrays(cfg, s, b=2) for s in (3, 11)])
    runs = []
    for n_tc, n_fwd, bwd_mb in ((-1, -1, -1), (1, 1, 2), (2, 2, 1),
                                (4, 1, 1)):
        tcfg = _tcfg(grad_accum_steps=2, fused_teacher_chunks=n_tc,
                     fused_fwd_chunks=n_fwd, fused_bwd_microbatches=bwd_mb)
        runs.append(_fused(cfg, tc, tcfg, [folded]))
    (first, (m0,)), rest = runs[0], runs[1:]
    for model, (m,) in rest:
        for k, v in m0.items():
            np.testing.assert_allclose(m[k], v, rtol=1e-6, err_msg=k)
        _assert_params(model, first, 1e-6)


def test_matches_the_jax_fused_step():
    cfg, tc = _configs(2, group=16, capacity=1.0)
    # cosine from its peak: the JAX step cannot take lr_schedule='constant'
    # (optax.constant_schedule returns a float, fused_steps.py:267 casts it)
    kw = {f.name: getattr(_tcfg(grad_accum_steps=2, lr_schedule="cosine"),
                          f.name)
          for f in dataclasses.fields(TrainConfig)}
    jcfg, jtc = to_jax_llava(cfg), to_jax_llava(tc)
    jparams = randomize_routers(jax.device_get(
        jllava.init(jcfg, jax.random.PRNGKey(0))))
    jteacher = jax.device_get(jllava.init(jtc, jax.random.PRNGKey(1)))
    student = tllava.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(student, jparams)
    teacher = tllava.init(tc, torch.Generator().manual_seed(0))
    load_jax_params(teacher, jteacher)
    teacher.requires_grad_(False)
    folded = _fold(cfg, _arrays(cfg, 3), _arrays(cfg, 11))

    stacked = dict(jparams, llm=jdecoder.stack_layers(jcfg.llm,
                                                      jparams["llm"]))
    jstate = jfused.init_fused_state(stacked, jcfg, JTrainConfig(**kw))
    jstate, jm = jfused.make_fused_align_step(jcfg, jtc, JTrainConfig(**kw))(
        jstate, jteacher, jbatch_from_arrays(folded))
    out = jax.device_get(jstate.params)
    out["llm"] = jdecoder.unstack_layers(jcfg.llm, out["llm"])
    want = flatten_numpy(out)

    state = init_fused_state(student, cfg, TrainConfig(**kw))
    state, m = make_fused_align_step(cfg, tc, TrainConfig(**kw))(
        state, teacher, _batch(folded))
    for k in ("loss", "loss/align", "loss/lm", "loss/moe_balance",
              "num_tokens", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    got = numpy_from_state_dict(student)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_fold_microbatches_matches_jax():
    cfg, _ = _configs(1)
    parts = [dict(_arrays(cfg, s), tag="x") for s in (3, 4, 5)]
    got = list(tloader.fold_microbatches(iter(parts), 3, rows_per_sample=4))
    want = list(jloader.fold_microbatches(iter(parts), 3, rows_per_sample=4))
    assert len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys()
    for k, v in want[0].items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    np.testing.assert_array_equal(got[0]["image_pos"][4:],
                                  parts[2]["image_pos"] + 4 * 4)
    for fold in (tloader.fold_microbatches, jloader.fold_microbatches):
        with pytest.raises(RuntimeError, match="dangling"):
            list(fold(iter(parts), 2, rows_per_sample=4))
