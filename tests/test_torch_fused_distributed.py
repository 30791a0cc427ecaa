"""The fused backward+update align step of the port
(llavamod_tpu_torch/train/fused_steps.py) under torch.distributed, on the
CPU under gloo: `run_stage("align", ..., fused_update=True,
optimizer="adafactor")` in 2 and 4 ranks spawned with
torch.multiprocessing, rendezvous through a FileStore, one row per rank and
microbatch, so the world's rows in rank order are the single-process
batch.  The model and data are tests/test_torch_distributed.py's (a tiny
LLaVA-MoD: 2 layers, width 64, 4 experts top-2 on both layers, capacity
factor 1.0, so the gate drops tokens; a dense teacher), weights carried
from the JAX package's init by interop/from_jax.py.

  * two updates at accumulation 2 (4 microbatches folded in pairs), with
    global gating (the step warns and takes the folded backward) and with
    gating groups of 128 tokens, which tile a rank's microbatch (the exact
    microbatched backward), at world 2 (fsdp=2) and world 4 ((data=2,
    expert=2) and (fsdp=2, tensor=2, sequence parallel)): every update's
    losses and grad_norm equal, within rel 2e-4, the single-process port's
    fused step on the world's rows and the JAX package's single-device
    `make_fused_align_step` on them, and rank 0's `model.pt` holds the
    single-process run's weights;
  * the sharded checkpoint after update 1 (the Adafactor statistics as
    every rank's shards) resumes update 2 to the same metrics and weights;
  * one Adafactor update of a factored [256, 256] parameter whose dim 0 is
    split over fsdp and dim 1 over tensor equals the whole one's."""

import dataclasses
import json
import os
import shutil
import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_distributed import (
    STEPS,
    ACCUM,
    TOL,
    TRAIN_MODULES,
    StubTok,
    _lines,
    _models,
    _stage_args,
    _state,
    _targs,
    _weights_close,
    _write_data,
)
from util_torch_port import to_jax_llava

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.train import fused_steps as jfused
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.steps import batch_from_arrays as jbatch_from_arrays
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.train.args import train_config_from_args

KEYS = ("loss", "loss/align", "loss/lm", "loss/moe_balance", "num_tokens",
        "grad_norm")
GROUP = 128     # tiles a rank's 256-token microbatch and the world's
FUSED = dict(optimizer="adafactor", fused_update=True)
MESHES_4 = {"data2_expert2": dict(data_parallel=2, expert_parallel=2),
            "fsdp2_tp_sp": dict(tensor_parallel=2, sequence_parallel=True)}
ROWS = {"fsdp2": 2, "data2_expert2": 4, "fsdp2_tp_sp": 2}


def _grouped_student(root):
    """The student's weights, gated in groups of GROUP tokens."""
    out = os.path.join(root, "student_g128")
    shutil.copytree(os.path.join(root, "student"), out)
    with open(os.path.join(out, builder.CONFIG_NAME)) as f:
        saved = json.load(f)
    saved["llm"]["moe_gating_group_size"] = GROUP
    with open(os.path.join(out, builder.CONFIG_NAME), "w") as f:
        json.dump(saved, f)


def _run(root, name, bsz, student, **targs):
    from llavamod_tpu_torch.train import run as trun

    margs, dargs, extra = _stage_args(root, "align", student)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trun.run_stage("align", margs, dargs,
                       _targs(os.path.join(root, name), bsz,
                              **dict(FUSED, **targs)),
                       tokenizer=StubTok(), device="cpu", **extra)
    return any("global gating" in str(w.message) for w in caught)


def _adafactor_leaf(rank, root):
    """One Adafactor update of a factored [256, 256] parameter, dim 0 split
    over fsdp and dim 1 over tensor, against the update of the whole."""
    from llavamod_tpu_torch.parallel.collectives import ParallelContext
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.train import adafactor

    pctx = ParallelContext(make_mesh(MeshConfig(fsdp=2, tensor=2), "cpu"))
    g = torch.Generator().manual_seed(3)
    p, grad = (torch.randn(256, 256, generator=g) for _ in range(2))
    whole, _ = adafactor.update_leaf(p, grad, adafactor.init_leaf(p), 0, 1e-2)
    f, t = rank // 2, rank % 2
    blk = (slice(f * 128, (f + 1) * 128), slice(t * 128, (t + 1) * 128))
    shards = ((256, 256), {0: [(pctx.fsdp_group, 2)],
                           1: [(pctx.tensor_group, 2)]})
    mine, state = adafactor.update_leaf(
        p[blk], grad[blk], adafactor.init_leaf(p[blk], (256, 256)), 0, 1e-2,
        shards=shards)
    parts = [torch.empty_like(mine) for _ in range(4)]
    dist.all_gather(parts, mine.contiguous())
    if rank == 0:
        got = torch.cat([torch.cat(parts[2 * i:2 * i + 2], dim=1)
                         for i in range(2)])
        torch.save({"whole": whole, "sharded": got,
                    "v_row": tuple(state["v_row"].shape),
                    "v_col": tuple(state["v_col"].shape)},
                   os.path.join(root, "adafactor_leaf.pt"))


def _world(rank, world, store, root, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for name, student, targs in cases:
            if name == "adafactor_leaf":
                _adafactor_leaf(rank, root)
            elif name == "resume":
                whole, cut = (os.path.join(root, f"resume_{p}")
                              for p in ("whole", "cut"))
                _run(root, "resume_whole", 1, student, save_steps=1)
                if rank == 0:
                    shutil.copytree(os.path.join(whole, "checkpoint-1"),
                                    os.path.join(cut, "checkpoint-1"))
                dist.barrier()
                _run(root, "resume_cut", 1, student, save_steps=1)
            else:
                warned = _run(root, name, 1, student, **targs)
                if rank == 0:
                    with open(os.path.join(root, name, "warned.json"),
                              "w") as f:
                        json.dump(warned, f)
    finally:
        dist.destroy_process_group()


def _folded_batches(root, student_cfg, bsz, student):
    """The single-process loader's microbatches of `bsz` rows, folded in
    pairs as the fused trainer folds them."""
    from llavamod_tpu_torch.train import run as trun
    from llavamod_tpu_torch.train.loader import (
        fold_microbatches,
        infinite_batches,
    )

    margs, dargs, _ = _stage_args(root, "align", student)
    loader = trun.build_data_module("align", margs, dargs,
                                    _targs(os.path.join(root, "unused"), bsz),
                                    StubTok(), student_cfg)
    it = infinite_batches(loader)
    folded = fold_microbatches(it, ACCUM, rows_per_sample=(
        student_cfg.max_images * student_cfg.num_image_tokens))
    out = [next(folded) for _ in range(STEPS // ACCUM)]
    it.close()
    return out


def _jax_metrics(root, student_cfg, jparams, teacher_cfg, jteacher, bsz,
                 group):
    """JAX's single-device `make_fused_align_step` on the world's folded
    rows, with the TrainConfig `run_stage` derives."""
    from llavamod_tpu_torch.train import run as trun

    cfg = student_cfg.replace(llm=student_cfg.llm.replace(
        moe_gating_group_size=group))
    student = "student_g128" if group else "student"
    margs, _, extra = _stage_args(root, "align", student)
    tcfg = train_config_from_args(
        "align", _targs(os.path.join(root, "unused"), bsz, **FUSED), STEPS,
        dataclasses.replace(margs, train_modules=trun.translate_train_modules(
            TRAIN_MODULES)), extra["salign"])
    jtcfg = JTrainConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(JTrainConfig)
                            if hasattr(tcfg, f.name)})
    jcfg = to_jax_llava(cfg)
    # a fresh copy: the JAX step donates its state
    fresh = jax.tree_util.tree_map(jax.numpy.array, jparams)
    stacked = dict(fresh, llm=jdecoder.stack_layers(jcfg.llm, fresh["llm"]))
    state = jfused.init_fused_state(stacked, jcfg, jtcfg)
    step = jfused.make_fused_align_step(jcfg, to_jax_llava(teacher_cfg),
                                        jtcfg)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in _folded_batches(root, cfg, bsz, student):
            state, m = step(state, jteacher, jbatch_from_arrays(b))
            out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 runs (spawned first, running while this
    process does the single-process and JAX references)."""
    root = str(tmp_path_factory.mktemp("fused_dist"))
    _write_data(root)
    student, jparams, teacher, jteacher = _models(root)
    _grouped_student(root)
    gatings = (("global", "student"), ("grouped", "student_g128"))
    cases2 = [(f"fsdp2_{g}", s, {}) for g, s in gatings]
    cases2 += [("resume", "student_g128", {})]
    cases4 = [(f"{m}_{g}", s, kw) for m, kw in MESHES_4.items()
              for g, s in gatings]
    cases4 += [("adafactor_leaf", None, {})]
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, cases2), (4, cases4))]
    torch.set_num_threads(1)
    warned = {}
    for bsz in (2, 4):
        for g, s in gatings:
            warned[(bsz, g)] = _run(root, f"single{bsz}_{g}", bsz, s)
    jax_metrics = {(bsz, g): _jax_metrics(root, student, jparams, teacher,
                                          jteacher, bsz,
                                          GROUP if g == "grouped" else 0)
                   for bsz in (2, 4) for g, _ in gatings}
    for p in procs:
        while not p.join():
            pass
    return root, jax_metrics, warned


def _close(got, want, tol=TOL, keys=KEYS):
    assert len(got) == len(want) == STEPS // ACCUM
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=tol,
                                           err_msg=f"update {i} {k}")


@pytest.mark.parametrize("gating", ["global", "grouped"])
@pytest.mark.parametrize("mesh", ["fsdp2", *MESHES_4])
def test_fused_update_matches_single_process_and_jax(runs, mesh, gating):
    root, jax_metrics, warned = runs
    name, bsz = f"{mesh}_{gating}", ROWS[mesh]
    single = f"single{bsz}_{gating}"
    got = _lines(os.path.join(root, name))
    _close(got, _lines(os.path.join(root, single)))
    _close(got, jax_metrics[(bsz, gating)])
    with open(os.path.join(root, name, "run_info.json")) as f:
        info = json.load(f)
    assert info["optimizer_updates"] == STEPS // ACCUM
    assert info["microbatches"] == STEPS
    assert info["mesh"]["tensor"] == (2 if "tp" in mesh else 1)
    # global gating warns and folds the backward, in the world as alone
    with open(os.path.join(root, name, "warned.json")) as f:
        assert json.load(f) == warned[(bsz, gating)] == (gating == "global")
    assert got[0]["loss/moe_balance"] > 0 and got[-1]["loss"] != got[0][
        "loss"]
    _weights_close(root, _state(os.path.join(root, name)),
                   _state(os.path.join(root, single)))


def test_rank0_model_pt_is_the_single_process_format(runs):
    root, _, _ = runs
    cfg, model = builder.load_model(os.path.join(root, "data2_expert2_global"),
                                    device="cpu")
    want = _state(os.path.join(root, "single4_global"))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert got["llm.layers.0.mlp.experts.up"].shape[0] == 4   # all experts
    assert cfg.llm.moe_num_experts == 4


def test_sharded_checkpoint_resumes_update_2(runs):
    root, _, _ = runs
    whole, cut = (os.path.join(root, f"resume_{p}") for p in ("whole", "cut"))
    files = os.listdir(os.path.join(whole, "checkpoint-1"))
    assert ".metadata" in files and "mesh.json" in files
    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    assert info["resumed_from"].endswith("checkpoint-1")
    assert info["microbatches"] == ACCUM
    assert info["optimizer_updates"] == STEPS // ACCUM
    a, b = _lines(whole)[1:], _lines(cut)
    assert [ln["step"] for ln in b] == [ln["step"] for ln in a] == [2]
    _close(a + a, b + b, tol=1e-6)
    _weights_close(root, _state(cut), _state(whole), tol=1e-6)


def test_factored_adafactor_leaf_sharded_over_fsdp_and_tensor(runs):
    root, _, _ = runs
    leaf = torch.load(os.path.join(root, "adafactor_leaf.pt"),
                      weights_only=True)
    assert leaf["v_row"] == (128,) and leaf["v_col"] == (128,)
    np.testing.assert_allclose(leaf["sharded"].numpy(), leaf["whole"].numpy(),
                               rtol=1e-5, atol=1e-7)
