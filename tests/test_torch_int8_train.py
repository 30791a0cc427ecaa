"""The int8 W8A8 training recipes of the port against the JAX package's, on
the CPU at tiny sizes (f32; tolerance TOL = 1.5e-3, the parity budget of
tests/test_torch_train_step.py):

  * stage 2 with `ref_quant=int8_head` and `policy_head_quant`: an int8
    teacher (body and head) and the student's frozen head pre-quantized
    (train/run.py `quantize_stage_models`), 2 steps of `make_align_step`,
    kd_lm, the record train set: every metric per step against JAX's step
    on the same quantized trees;
  * the router-only `policy_body_quant` recipe: the whole student body in
    int8 (experts included), gradients reaching the routers through the
    straight-through backward of every int8 matmul: loss and grad_norm
    against JAX, and every non-router weight bitwise unchanged;
  * `train.run.main` on a tiny model pair with the repository's stage-2
    config (`configs/dense2sparse_qwen2_0_5b.json`) as written: it trains
    with the config's int8_head teacher and pre-quantized student head, and
    the checkpoint it saves holds the float student head bitwise."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from util_torch_port import matched_llava, tiny_llava_config, to_jax_llava

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llm import decoder as jdec
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
from llavamod_tpu_torch.models import builder as tbuilder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import AlignArgs
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

TOL = 1.5e-3
VOCAB, CHUNK, T = 1000, 96, 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "loss/align", "loss/lm", "loss/moe_balance", "num_tokens",
           "grad_norm")


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    b, n_img, s = 2, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, VOCAB, (b, T)).astype(np.int32)
    im = np.zeros((b, T), bool)
    ip = np.zeros((b, T), np.int32)
    for i in range(b):
        im[i, 1:1 + n_img] = True
        ip[i, 1:1 + n_img] = i * n_img + np.arange(n_img)
    labels = np.where(im, -100, ids)
    labels[:, :T // 4] = -100
    return {"input_ids": ids, "segment_ids": np.ones((b, T), np.int32),
            "image_mask": im, "image_pos": ip,
            "pixels": rng.randn(b, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((b, 1), bool), "labels": labels}


def _pair():
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


def _run_both(kw, jparams, jteacher, model, tmodel, student, teacher,
              steps=2):
    """`steps` steps of both packages' make_align_step; returns the port's
    state and per-step (port, JAX) metrics."""
    arrays = _batch(student)
    jstep = jmake_align_step(to_jax_llava(student), to_jax_llava(teacher),
                             JTrainConfig(**kw))
    jstate = JTrainState.create(jparams, JTrainConfig(**kw))
    step = make_align_step(student, teacher, TrainConfig(**kw))
    state = TrainState.create(model, TrainConfig(**kw))
    jb = jbatch_from_arrays(arrays)
    tb = batch_from_arrays(arrays, device="cpu")
    out = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jteacher, jb)
        state, m = step(state, tmodel, tb)
        out.append(({k: v.item() for k, v in m.items()},
                    {k: float(v) for k, v in jm.items()}))
    return state, out


def _check(metrics, names):
    for i, (got, want) in enumerate(metrics):
        for name in names:
            np.testing.assert_allclose(got[name], want[name], rtol=TOL,
                                       atol=TOL, err_msg=f"step {i} {name}")


def test_int8_head_teacher_and_prequantized_student_head_match_jax():
    student, teacher, jparams, model, jteacher, tmodel = _pair()
    kw = dict(stage="align", align_loss_type="kd_lm", compute_dtype="float32",
              vocab_chunk=CHUNK, learning_rate=5e-4, warmup_ratio=0.0,
              max_grad_norm=1.0, student_head_quant=True,
              train_modules=("/gate", "/up", "/down", "router"))
    # JAX run.py's build: the teacher's LLM with its head to int8, the
    # student's explicit frozen head pre-quantized
    jteacher = dict(jteacher, llm=jdec.quantize_decoder_int8(
        jteacher["llm"], include_lm_head=True))
    jparams = dict(jparams, llm=dict(jparams["llm"], lm_head={
        "weight": jdec.quantize_head_int8(
            jparams["llm"]["lm_head"]["weight"])}))
    float_head = model.llm.lm_head.weight.detach().clone()
    stash = trun.quantize_stage_models(
        TrainConfig(**kw), AlignArgs(ref_quant="int8_head"), model, tmodel)
    assert isinstance(tmodel.llm.lm_head.weight, Int8Weight)
    assert isinstance(tmodel.llm.layers[1].attn.wqkv, Int8Weight)
    assert isinstance(model.llm.lm_head.weight, Int8Weight)
    assert torch.equal(stash["head"], float_head)
    # the same int8 values on both sides (rounding ties aside)
    load_jax_params(tmodel, jax.device_get(jteacher))
    load_jax_params(model, jax.device_get(jparams))
    state, metrics = _run_both(kw, jparams, jteacher, model, tmodel, student,
                               teacher)
    _check(metrics, METRICS)
    trun.restore_float_weights(state.model, stash)
    assert torch.equal(state.model.llm.lm_head.weight, float_head)


def test_router_only_body_quant_step_matches_jax():
    student, teacher, jparams, model, jteacher, tmodel = _pair()
    kw = dict(stage="align", align_loss_type="kd_lm", compute_dtype="float32",
              vocab_chunk=CHUNK, learning_rate=5e-3, warmup_ratio=0.0,
              student_body_quant=True, freeze_mm_mlp_adapter=True,
              train_modules=("router",))
    jparams = dict(jparams, llm=jdec.quantize_decoder_int8(
        jparams["llm"], include_experts=True))
    before = numpy_from_state_dict(model)
    stash = trun.quantize_stage_models(TrainConfig(**kw), AlignArgs(), model,
                                       tmodel)
    layer0 = model.llm.layers[0]
    assert isinstance(layer0.mlp.experts.gate, Int8Weight)
    assert isinstance(model.llm.layers[1].mlp.gate_up, Int8Weight)
    assert isinstance(layer0.attn.wqkv, Int8Weight)
    load_jax_params(model, jax.device_get(jparams))
    quantized = numpy_from_state_dict(model)
    state, metrics = _run_both(kw, jparams, jteacher, model, tmodel, student,
                               teacher)
    _check(metrics, ("loss", "loss/align", "loss/lm", "grad_norm"))
    assert all(got["grad_norm"] > 0 for got, _ in metrics)
    after = numpy_from_state_dict(state.model)
    moved = {k for k in after if not np.array_equal(after[k], quantized[k])}
    assert moved == {"llm.layers.0.mlp.router"}
    # the export: the float body back, with the trained router grafted in
    trun.restore_float_weights(state.model, stash)
    restored = numpy_from_state_dict(state.model)
    assert set(restored) == set(before)
    assert {k for k in before if not np.array_equal(before[k], restored[k])
            } == {"llm.layers.0.mlp.router"}
    np.testing.assert_array_equal(restored["llm.layers.0.mlp.router"],
                                  after["llm.layers.0.mlp.router"])


def test_policy_body_quant_refuses_a_trainable_body():
    student, _, _, model, _, tmodel = _pair()
    tcfg = TrainConfig(stage="align", student_body_quant=True,
                       train_modules=("/up", "router"))
    with pytest.raises(ValueError, match="router"):
        trun.quantize_stage_models(tcfg, AlignArgs(), model, tmodel)


class _Tok:
    """Character ids below the tiny vocab; no BOS."""
    bos_token_id = None
    pad_token_id = 0
    eos_token_id = None

    def __call__(self, text):
        return type("R", (), {"input_ids": [ord(c) % 500 + 3 for c in text]})()


def test_stage2_config_as_written_trains_int8_and_saves_the_float_head(
        tmp_path, monkeypatch):
    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    student = tllava.init(cfg, torch.Generator().manual_seed(0))
    teacher = tllava.init(cfg.replace(llm=cfg.llm.replace(
        hidden_size=96, num_layers=1, name="tiny-teacher")),
        torch.Generator().manual_seed(1), vision=False)
    sdir, tdir = str(tmp_path / "student"), str(tmp_path / "teacher")
    tbuilder.save_model(sdir, student)
    tbuilder.save_model(tdir, teacher)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rows = []
    for i in range(4):
        Image.new("RGB", (32, 32), (i * 40, 30, 40)).save(imgs / f"{i}.png")
        rows.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat is this?"},
            {"from": "gpt", "value": f"a red bus {i}"}]})
    (tmp_path / "sft.json").write_text(json.dumps(rows))

    seen = {}
    quantize = trun.quantize_stage_models

    def spy(tcfg, stage_args, model, teacher_model):
        stash = quantize(tcfg, stage_args, model, teacher_model)
        seen.update(ref_quant=stage_args.ref_quant,
                    teacher=isinstance(teacher_model.llm.lm_head.weight,
                                       Int8Weight),
                    student=isinstance(model.llm.lm_head.weight, Int8Weight))
        return stash

    monkeypatch.setattr(trun, "quantize_stage_models", spy)
    monkeypatch.setattr(trun, "load_tokenizer", lambda margs: _Tok())
    out = str(tmp_path / "out")
    trun.main(["--stage", "align", "--config",
               os.path.join(REPO, "configs", "dense2sparse_qwen2_0_5b.json"),
               "--policy_model_name_or_path", sdir,
               "--ref_model_name_or_path", tdir,
               "--data_path", str(tmp_path / "sft.json"),
               "--image_folder", str(imgs), "--output_dir", out,
               "--max_steps", "2", "--gradient_accumulation_steps", "1",
               "--model_max_length", "256", "--compute_dtype", "float32",
               "--vocab_chunk", "128", "--dataloader_num_workers", "0"],
              device="cpu")
    assert seen == {"ref_quant": "int8_head", "teacher": True, "student": True}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 2
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    saved = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    assert torch.equal(saved["llm.lm_head.weight"],
                       student.llm.lm_head.weight.detach())
    assert "llm.layers.0.mlp.experts.up" in saved      # upcycled in-stage
    assert not any("w_int8" in k for k in saved)
