"""Pipeline parallelism of the port (llavamod_tpu_torch/parallel/
pipeline.py, the decoder's pipelined layer loop, train/run.py with
--pipeline_parallel) on the CPU under gloo: worlds of 2 and 4 ranks spawned
with torch.multiprocessing, rendezvous through a FileStore.  The ranks of a
pipe group hold the same rows, so a world of 2 at pipe=2 trains the whole
batch of 2 rows as 2 microbatches of one row.  The models are
tests/test_torch_distributed.py's (a tiny LLaVA-MoD: 2 layers, width 64, 4
experts top-2 on both layers, capacity factor 1.0, and a tiny dense
teacher) with gating groups of one sequence (256 tokens), so that the
microbatch gating of the pipeline is the single-process gating; a 4-layer
pair of the same widths runs pipe=4.

  * the pipelined decoder (4 layers) at pipe=2 and pipe=4, dense and MoE
    (every layer: a period of 1), forward and gradients against the JAX
    package's own pipelined program (`decoder.forward` under a pipe mesh of
    the conftest's virtual CPU devices), rel 1e-5 in f32: with gating
    groups of 12 tokens, which divide no microbatch (microbatch gating is
    what both compare), and of 16, one microbatch row, where the pipeline
    also equals the sequential forward;
  * whole steps, every microbatch's loss and grad_norm within rel 2e-4 of
    the single-process port on the same rows and, for stage 2b, of the JAX
    package's single-device `make_align_step`: stage 2b (AdamW,
    accumulation 2) at pipe=2, (pipe=2, data=2), (pipe=2, fsdp=2), (pipe=2,
    expert=2), (pipe=2, tensor=2, SP, remat) and pipe=4, stage 1 (projector
    only), stage 3 (kto_pair), Adafactor and LoRA at pipe=2; rank 0's
    `model.pt` (and LoRA's `adapter/`) in the single-process format with the
    single-process weights;
  * the parameters outside the layers are equal on the pipe ranks after
    the updates (AdamW and Adafactor); the sharded checkpoint at pipe=2
    resumes update 2 to the same metrics and weights;
  * refusals: the fused step (JAX's ValueError), a batch the microbatches
    do not divide, and layer repeats pipe does not divide;
  * a cached call of the decoder at pipe=2, once refused, returns the
    single process's hidden and cache (tests/test_torch_pipeline_decode.py
    holds the un-pipelined paths under pipe > 1 to JAX)."""

import dataclasses
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_distributed import (
    ACCUM,
    METRICS,
    STEPS,
    TOL,
    _close,
    _jax_metrics,
    _lines,
    _models,
    _stage_args,
    _state,
    _targs,
    _weights_close,
    _write_data,
    StubTok,
)
from util_torch_port import flatten_numpy, tiny_llava_config, to_jax_llm

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from llavamod_tpu.parallel.mesh import make_mesh as jmake_mesh
from llavamod_tpu.parallel.sharding import shard_params as jshard_params
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.llm.config import tiny_config

OP_TOL = 1e-5
SEQ = 256                  # gating groups of one sequence
LORA = dict(lora_enable=True, lora_r=4, lora_alpha=8, only_lora_ffn=False)
PP2 = dict(pipeline_parallel=2)
# decoder checks: (layers MoE, gating group, pipe); B = 4 rows of 16
DECODER = {"dec2_dense": (False, 0, 2), "dec2_moe_g12": (True, 12, 2),
           "dec2_moe_g16": (True, 16, 2), "dec4_dense": (False, 0, 4),
           "dec4_moe_g12": (True, 12, 4)}
STEPS2 = {"pp": ("align", 2, PP2), "pp_pretrain": ("pretrain", 2, PP2),
          "pp_dpo": ("dpo", 2, PP2),
          "pp_adafactor": ("align", 2, dict(PP2, optimizer="adafactor")),
          "pp_lora": ("align", 2, PP2)}
STEPS4 = {"pp_data2": ("align", 2, dict(PP2, data_parallel=2)),
          "pp_fsdp2": ("align", 2, PP2),
          "pp_expert2": ("align", 2, dict(PP2, expert_parallel=2)),
          "pp_tp_sp": ("align", 2, dict(PP2, tensor_parallel=2,
                                        sequence_parallel=True, remat=True)),
          "pp4": ("align", 4, dict(pipeline_parallel=4))}


# ---------------------------------------------------------------------------
# the pipelined decoder against JAX's pipelined program
# ---------------------------------------------------------------------------

def _dec_cfg(moe: bool, group: int):
    return tiny_config(num_layers=4, moe_num_experts=4 if moe else 0,
                       moe_layers=(0, 1, 2, 3) if moe else (),
                       moe_capacity_factor=1.0, moe_gating_group_size=group)


def _dec_inputs(cfg):
    rng = np.random.RandomState(5)
    ids = rng.randint(2, cfg.vocab_size, (4, 16)).astype(np.int32)
    pattern = rng.randn(4, 16, cfg.hidden_size).astype(np.float32)
    return ids, pattern


def _jax_decoder(root, name):
    """JAX's pipelined forward and gradients of sum(hidden * pattern) +
    aux; the same weights saved for the port."""
    moe, group, pipe = DECODER[name]
    cfg = _dec_cfg(moe, group)
    jcfg = to_jax_llm(cfg)
    params = jdecoder.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    for layer in params["layers"]:
        if "router" in layer["mlp"]:
            r = layer["mlp"]["router"]
            layer["mlp"]["router"] = jnp.asarray(
                rng.randn(*r.shape).astype(np.float32))
    port = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(port, jax.device_get(params))
    torch.save(port.state_dict(), os.path.join(root, f"{name}_weights.pt"))
    ids, pattern = _dec_inputs(cfg)

    def loss(p):
        out = jdecoder.forward(p, jcfg, input_ids=jnp.asarray(ids),
                               train=True)
        return (jnp.sum(out.hidden * pattern) + out.aux_loss,
                (out.hidden, out.aux_loss))

    mesh = jmake_mesh(JMeshConfig(pipe=pipe), jax.devices()[:pipe])
    with jax.set_mesh(mesh):
        p = jshard_params(mesh, params)
        (_, (h, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
    sequential = None
    if group == 16:
        with torch.no_grad():
            out = tdecoder.forward(port, cfg, input_ids=torch.as_tensor(ids),
                                   train=True)
        sequential = dict(h=out.hidden.numpy(), aux=float(out.aux_loss))
    return dict(h=np.asarray(h), aux=float(aux),
                grads=flatten_numpy(jax.device_get(g)), sequential=sequential)


def _port_decoder(rank, root, name):
    """The port's pipelined forward and gradients on this rank's stage."""
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.pipeline import keep_stage_layers

    moe, group, pipe = DECODER[name]
    cfg = _dec_cfg(moe, group)
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(root, f"{name}_weights.pt"),
                                     weights_only=True))
    pctx = ParallelContext(make_mesh(MeshConfig(pipe=pipe), "cpu"))
    keep_stage_layers(model, pipe, pctx.pipe_rank)
    ids, pattern = _dec_inputs(cfg)
    with active(pctx):
        out = tdecoder.forward(model, cfg, input_ids=torch.as_tensor(ids),
                               train=True)
        loss = (out.hidden * torch.as_tensor(pattern)).sum() + out.aux_loss
        loss.backward()
    torch.save(dict(h=out.hidden.detach(), aux=float(out.aux_loss),
                    stage=pctx.pipe_rank, layers=model.layers.indices,
                    grads={n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}),
               os.path.join(root, f"{name}_rank{rank}.pt"))


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def _grouped(root, src, dst, **llm):
    """A copy of the model directory `src` whose LLM config takes `llm`."""
    shutil.copytree(os.path.join(root, src), os.path.join(root, dst))
    path = os.path.join(root, dst, builder.CONFIG_NAME)
    with open(path) as f:
        saved = json.load(f)
    saved["llm"].update(llm)
    with open(path, "w") as f:
        json.dump(saved, f)


def _models4(root):
    """A 4-layer student (MoE on every layer, gating groups of one
    sequence) and a 4-layer dense teacher, for pipe=4."""
    from util_torch_port import matched_llava

    from llavamod_tpu_torch.models import llava as tllava

    student = tiny_llava_config(moe_num_experts=4, moe_layers=(0, 1, 2, 3),
                                moe_capacity_factor=1.0, num_layers=4,
                                moe_gating_group_size=SEQ)
    builder.save_model(os.path.join(root, "student4"),
                       matched_llava(student, seed=0)[2])
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", hidden_size=96, intermediate_size=160,
        num_heads=4, num_kv_heads=4, moe_num_experts=0, moe_layers=()))
    builder.save_model(os.path.join(root, "teacher4"), tllava.init(
        teacher, torch.Generator().manual_seed(7)))


def _run(root, name, stage, bsz, lora=False, four=False, **targs):
    """`run_stage` of tests/test_torch_distributed.py on the students with
    gating groups of one sequence (`four`: the 4-layer pair)."""
    from llavamod_tpu_torch.train import run as trun

    margs, dargs, extra = _stage_args(
        root, stage, "student4" if four else "student_seq")
    if stage == "pretrain":
        margs = dataclasses.replace(margs, model_name_or_path=os.path.join(
            root, "student_seq"))
    if four and "salign" in extra:
        extra["salign"] = dataclasses.replace(
            extra["salign"], ref_model_name_or_path=os.path.join(
                root, "teacher4"))
    if stage == "dpo":
        extra["sdpo"] = dataclasses.replace(
            extra["sdpo"], policy_model_name_or_path=os.path.join(
                root, "student_seq"))
    if lora:
        margs = dataclasses.replace(margs, **LORA)
    return trun.run_stage(stage, margs, dargs,
                          _targs(os.path.join(root, name), bsz, **targs),
                          tokenizer=StubTok(), device="cpu", **extra)


def _run_keeping_replicas(root, name, stage, bsz, rank, **targs):
    """`_run`, and each rank's parameters outside the layers at the end."""
    from llavamod_tpu_torch.parallel.pipeline import is_stage_key
    from llavamod_tpu_torch.parallel.sharding import local_tensor
    from llavamod_tpu_torch.train import run as trun

    kept = {}
    orig = trun.final_save

    def final_save(output_dir, cfg, state, *a, **k):
        for n, p in state.model.named_parameters():
            if not is_stage_key(n):
                kept[n] = local_tensor(p).detach().clone()
        return orig(output_dir, cfg, state, *a, **k)

    trun.final_save = final_save
    try:
        _run(root, name, stage, bsz, lora=name.endswith("lora"),
             four=targs.get("pipeline_parallel") == 4, **targs)
    finally:
        trun.final_save = orig
    torch.save(kept, os.path.join(root, f"{name}_replicas{rank}.pt"))


def _cached_call(rank, root):
    """The decoder call the port once refused under pipe=2: a 2-layer
    decoder with a KV cache, on this rank's stage."""
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.pipeline import keep_stage_layers

    cfg = tiny_config()
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    pctx = ParallelContext(make_mesh(MeshConfig(pipe=2), "cpu"))
    keep_stage_layers(model, 2, pctx.pipe_rank)
    with active(pctx), torch.no_grad():
        cache = tdecoder.init_cache(cfg, 2, 8, dtype=torch.float32)
        out = tdecoder.forward(model, cfg, input_ids=torch.ones(
            2, 4, dtype=torch.long), cache=cache)
    torch.save(dict(h=out.hidden, k=out.cache.k, v=out.cache.v,
                    length=out.cache.length),
               os.path.join(root, f"cached_rank{rank}.pt"))


def _world(rank, world, store, root, decoder_cases, step_cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        if world == 2:
            _cached_call(rank, root)
        for name in decoder_cases:
            _port_decoder(rank, root, name)
        for name, (stage, bsz, targs) in step_cases.items():
            _run_keeping_replicas(root, name, stage, bsz, rank, **targs)
        if world == 2:          # resume_pp: update 1 saved, then resumed
            whole, cut = (os.path.join(root, f"resume_pp_{p}")
                          for p in ("whole", "cut"))
            _run(root, os.path.basename(whole), "align", 2, save_steps=ACCUM,
                 **PP2)
            if rank == 0:
                shutil.copytree(os.path.join(whole, f"checkpoint-{ACCUM}"),
                                os.path.join(cut, f"checkpoint-{ACCUM}"))
            dist.barrier()
            _run(root, os.path.basename(cut), "align", 2, save_steps=ACCUM,
                 **PP2)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pipe worlds (spawned first, running while this process does the
    single-process and JAX references)."""
    root = str(tmp_path_factory.mktemp("pp"))
    _write_data(root)
    student, jparams, teacher, jteacher = _models(root)
    _grouped(root, "student", "student_seq", moe_gating_group_size=SEQ)
    _models4(root)
    jax_dec = {name: _jax_decoder(root, name) for name in DECODER}
    dec2 = [n for n in DECODER if DECODER[n][2] == 2]
    dec4 = [n for n in DECODER if DECODER[n][2] == 4]
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, d, s),
                      nprocs=w, join=False)
             for w, d, s in ((2, dec2, STEPS2), (4, dec4, STEPS4))]
    torch.set_num_threads(1)
    for name, stage, bsz, kw in (
            ("single_align2", "align", 2, {}),
            ("single_align4", "align", 4, {}),
            ("single4_align4", "align", 4, dict(four=True)),
            ("single_pretrain2", "pretrain", 2, {}),
            ("single_dpo2", "dpo", 2, {}),
            ("single_adafactor2", "align", 2, dict(optimizer="adafactor")),
            ("single_lora2", "align", 2, dict(lora=True))):
        _run(root, name, stage, bsz, **kw)
    seq = student.replace(llm=student.llm.replace(moe_gating_group_size=SEQ))
    jax_metrics = {b: _jax_metrics(root, seq, jparams, teacher, jteacher, b)
                   for b in (2, 4)}
    for p in procs:
        while not p.join():
            pass
    return root, jax_metrics, jax_dec


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a, np.float64))
    b = torch.as_tensor(np.asarray(b, np.float64))
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(DECODER))
def test_pipelined_decoder_matches_jax_pipelined_program(runs, name):
    root, _, jax_dec = runs
    want = jax_dec[name]
    pipe = DECODER[name][2]
    owned = set()
    for rank in range(pipe):
        got = torch.load(os.path.join(root, f"{name}_rank{rank}.pt"),
                         weights_only=True)
        assert got["stage"] == rank
        assert got["layers"] == list(range(rank * 4 // pipe,
                                           (rank + 1) * 4 // pipe))
        assert _rel(got["h"], want["h"]) <= OP_TOL, (rank, "hidden")
        assert got["aux"] == pytest.approx(want["aux"], rel=OP_TOL)
        for k, g in got["grads"].items():
            layer = k.startswith("layers.")
            if layer or rank == 0:
                owned.add(k)
                assert _rel(g, want["grads"][k]) <= OP_TOL, (rank, k)
    # every gradient JAX takes has its owner (zero entries aside)
    missing = {k for k, v in want["grads"].items()
               if np.abs(v).max() > 0} - owned
    assert not missing, missing
    if want["sequential"] is not None:   # groups of one microbatch row
        seq = want["sequential"]
        assert _rel(want["h"], seq["h"]) <= OP_TOL
        assert want["aux"] == pytest.approx(seq["aux"], rel=OP_TOL)


@pytest.mark.parametrize("name", ["pp", "pp_data2", "pp_fsdp2", "pp_expert2",
                                  "pp_tp_sp", "pp4"])
def test_pipeline_align_matches_single_process_and_jax(runs, name):
    root, jax_metrics, _ = runs
    stage, bsz, targs = {**STEPS2, **STEPS4}[name]
    rows = 4 if name in ("pp_data2", "pp_fsdp2", "pp_expert2") else 2
    single = "single4_align4" if name == "pp4" else f"single_align{rows}"
    got = _lines(os.path.join(root, name))
    _close(got, _lines(os.path.join(root, single)), TOL)
    if name != "pp4":
        _close(got, jax_metrics[rows], TOL)
    with open(os.path.join(root, name, "run_info.json")) as f:
        info = json.load(f)
    assert info["optimizer_updates"] == STEPS // ACCUM
    pipe = targs["pipeline_parallel"]
    assert info["mesh"] == dict(
        data=targs.get("data_parallel", 1),
        fsdp=2 if name == "pp_fsdp2" else 1,
        expert=targs.get("expert_parallel", 1),
        tensor=targs.get("tensor_parallel", 1), pipe=pipe)
    assert got[0]["loss/moe_balance"] > 0
    if name != "pp4":
        _weights_close(root, _state(os.path.join(root, name)),
                       _state(os.path.join(root, single)))
    else:
        a, b = _state(os.path.join(root, name)), _state(os.path.join(
            root, single))
        assert a.keys() == b.keys()
        for k in a:
            assert _rel(a[k].double().numpy(), b[k].double().numpy()) \
                <= 1e-3, k


@pytest.mark.parametrize("stage,name", [("pretrain", "pp_pretrain"),
                                        ("dpo", "pp_dpo"),
                                        ("align", "pp_adafactor")])
def test_pipeline_stage_1_3_and_adafactor_match_single_process(runs, stage,
                                                               name):
    root, _, _ = runs
    single = ("single_adafactor2" if name == "pp_adafactor"
              else f"single_{stage}2")
    got = _lines(os.path.join(root, name))
    want = _lines(os.path.join(root, single))
    keys = {"pretrain": ("loss", "loss/lm", "num_tokens", "grad_norm"),
            "dpo": ("loss", "loss/dpo", "logps/chosen", "logps/rejected",
                    "rewards/margins", "loss/moe_balance", "grad_norm"),
            "align": METRICS}[stage]
    _close(got, want, TOL, keys)
    _weights_close(root, _state(os.path.join(root, name)),
                   _state(os.path.join(root, single)))


def test_pipeline_lora_matches_single_process(runs):
    """LoRA at pipe=2: each stage keeps its layers' adapters; rank 0 joins
    them into `adapter/` and merges them into `model.pt`."""
    root, _, _ = runs
    got = os.path.join(root, "pp_lora")
    want = os.path.join(root, "single_lora2")
    _close(_lines(got), _lines(want), TOL)
    _weights_close(root, _state(got), _state(want))
    a = torch.load(os.path.join(got, "adapter", "adapter_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(want, "adapter", "adapter_model.bin"),
                   weights_only=True)
    assert a.keys() == b.keys() and any(".layers.1." in k for k in a)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    names = [torch.load(os.path.join(p, "adapter", "non_lora_trainables.bin"),
                        weights_only=True).keys() for p in (got, want)]
    assert names[0] == names[1]


@pytest.mark.parametrize("name", ["pp", "pp_adafactor"])
def test_replicated_parameters_are_equal_over_the_pipe_ranks(runs, name):
    root, _, _ = runs
    a, b = (torch.load(os.path.join(root, f"{name}_replicas{r}.pt"),
                       weights_only=True) for r in (0, 1))
    assert a.keys() == b.keys() and any("projector" in k for k in a)
    assert not any(".layers." in k and k.startswith("llm.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_pipeline_checkpoint_resumes_update_2(runs):
    root, _, _ = runs
    whole = os.path.join(root, "resume_pp_whole")
    cut = os.path.join(root, "resume_pp_cut")
    with open(os.path.join(whole, f"checkpoint-{ACCUM}", "mesh.json")) as f:
        assert json.load(f)["mesh"]["pipe"] == 2
    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    assert info["resumed_from"].endswith(f"checkpoint-{ACCUM}")
    assert info["microbatches"] == STEPS - ACCUM
    a, b = _lines(whole)[ACCUM:], _lines(cut)
    assert [ln["step"] for ln in b] == [ln["step"] for ln in a]
    for x, y in zip(a, b):
        for k in METRICS:
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)
    _weights_close(root, _state(cut), _state(whole), tol=1e-6)


def test_pipeline_model_pt_is_the_single_process_format(runs):
    root, _, _ = runs
    cfg, model = builder.load_model(os.path.join(root, "pp"), device="cpu")
    want = _state(os.path.join(root, "single_align2"))
    got = model.state_dict()
    assert list(got.keys()) == list(want.keys())
    for k in got:
        assert got[k].shape == want[k].shape, k


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

class _PipeCtx:
    """A stand-in context of pipe=2 (the refusals come before any
    collective)."""
    pipe_size, pipe_rank, tensor_size = 2, 0, 1


def test_fused_update_is_refused_under_the_pipeline(monkeypatch):
    from llavamod_tpu_torch.train.args import ModelArgs, TrainArgs
    from llavamod_tpu_torch.train.run import refuse_unported

    monkeypatch.setenv("WORLD_SIZE", "2")
    targs = TrainArgs(output_dir="unused", pipeline_parallel=2,
                      optimizer="adafactor", fused_update=True)
    with pytest.raises(ValueError, match="cannot run under "
                       "--pipeline_parallel; drop one of the two"):
        refuse_unported(ModelArgs(), targs)
    refuse_unported(ModelArgs(), dataclasses.replace(targs,
                                                     fused_update=False))


def test_a_batch_the_microbatches_do_not_divide_is_refused():
    from llavamod_tpu_torch.parallel.collectives import active

    cfg = tiny_config()
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    with active(_PipeCtx()), pytest.raises(
            ValueError, match="batch 3 not divisible into 2 microbatches"):
        tdecoder.forward(model, cfg, input_ids=torch.ones(3, 8,
                                                          dtype=torch.long))


def test_layer_repeats_pipe_does_not_divide_are_refused():
    from llavamod_tpu_torch.parallel.pipeline import (
        _layer_period,
        stage_block,
    )

    sparse = tiny_config(num_layers=6, moe_num_experts=4,
                         moe_layers=(0, 2, 4))
    assert _layer_period(sparse) == 2
    assert list(stage_block(sparse, 3, 1)) == [2, 3]
    with pytest.raises(ValueError,
                       match="3 layer repeats not divisible by pipe=2"):
        stage_block(sparse, 2, 0)


def test_a_cache_under_the_pipeline_returns_the_single_process_result(runs):
    """The call that once raised at pipe=2 (ROADMAP item 17) returns the
    single process's hidden on both stages, each stage's cache holding its
    layer's slot of the single process's cache."""
    root, _, _ = runs
    cfg = tiny_config()
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cache = tdecoder.init_cache(cfg, 2, 8, dtype=torch.float32)
        want = tdecoder.forward(model, cfg, input_ids=torch.ones(
            2, 4, dtype=torch.long), cache=cache)
    for rank in range(2):
        got = torch.load(os.path.join(root, f"cached_rank{rank}.pt"),
                         weights_only=True)
        assert _rel(got["h"], want.hidden) <= OP_TOL
        assert got["length"] == want.cache.length == 4
        for key in ("k", "v"):
            assert got[key].shape[0] == 1
            assert _rel(got[key], getattr(want.cache, key)[rank:rank + 1]) \
                <= OP_TOL, (rank, key)
