"""LoRA adapters (llavamod_tpu_torch/models/lora.py) beside a model that
FSDP2 shards, under torch.distributed, on the CPU under gloo: `run_stage`
with --lora_enable (r 4, alpha 8, on attention and the FFN, the experts'
per expert: the attention adapters whole over the rows, the experts' the
expert rank's, each split as its base under tensor parallelism) in
2 and 4 ranks spawned with torch.multiprocessing, rendezvous through a
FileStore, one row per rank, so the world's rows in rank order are the
single-process batch.  The model and data are tests/test_torch_
distributed.py's (a tiny LLaVA-MoD: 2 layers, width 64, 4 experts top-2 on
both layers; a dense teacher), weights carried from the JAX package's init.

  * stage 2b (kd_lm, the record train set: the adapters, the routers and
    the projector train, the adapted weights are frozen; AdamW,
    accumulation 2) at world 2 (fsdp=2) and world 4 ((expert=2, fsdp=2)
    and (fsdp=2, tensor=2), both recomputing each layer), stages 1 and 3
    at world 2: every
    microbatch's losses and grad_norm within rel 2e-4 of the
    single-process port on the world's rows and, for stage 2b, of the JAX
    package's single-device `make_align_step(..., lora_cfg)` handed the
    same adapters;
  * rank 0 writes `adapter/` (PEFT's layout, every expert's adapters),
    `non_lora_trainables.bin` and the merged `model.pt`: the single-process
    run's values, every `b` moved, every weight the adapters leave alone
    bitwise the start, each adapted weight the start plus the adapters'
    product; `load_pretrained_model(adapter, model_base=start)` equals the
    merged directory;
  * the sharded checkpoint after update 1 (the adapters and their AdamW
    moments among every rank's shards) resumes update 2 to the same
    metrics, adapters and merged weights."""

import dataclasses
import os
import shutil
import tempfile

import jax
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
    TRAIN_MODULES,
    StubTok,
    _close,
    _lines,
    _models,
    _stage_args,
    _state,
    _targs,
    _weights_close,
    _write_data,
)
from util_torch_port import to_jax_llava

from llavamod_tpu.models import lora as jlora
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.optim import TrainState as JTrainState
from llavamod_tpu.train.steps import (
    batch_from_arrays as jbatch_from_arrays,
    make_align_step as jmake_align_step,
)
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import lora as tlora
from llavamod_tpu_torch.train.args import train_config_from_args

# attention and FFN targets: the dense wq / wk / wv / wo beside the experts
LORA = dict(lora_enable=True, lora_r=4, lora_alpha=8, only_lora_ffn=False)
SEED = 42            # TrainArgs.seed: the adapters are drawn from SEED + 1
# remat: a recompute that stops once it has what the backward needs
# (torch.utils.checkpoint's early stop) never reaches the unit's forward hook
MESHES_4 = {"expert2": dict(expert_parallel=2, remat=True),
            "tp2": dict(tensor_parallel=2, remat=True)}
ROWS = {"align": 2, "expert2": 4, "tp2": 2}


def _run(root, name, stage, bsz, **targs):
    from llavamod_tpu_torch.train import run as trun

    margs, dargs, extra = _stage_args(root, stage)
    return trun.run_stage(stage, dataclasses.replace(margs, **LORA), dargs,
                          _targs(os.path.join(root, name), bsz, **targs),
                          tokenizer=StubTok(), device="cpu", **extra)


def _world(rank, world, store, root, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for name, stage, targs in cases:
            if name == "resume":
                whole, cut = (os.path.join(root, f"resume_{p}")
                              for p in ("whole", "cut"))
                _run(root, "resume_whole", stage, 1, save_steps=ACCUM)
                if rank == 0:
                    shutil.copytree(os.path.join(whole, f"checkpoint-{ACCUM}"),
                                    os.path.join(cut, f"checkpoint-{ACCUM}"))
                dist.barrier()
                _run(root, "resume_cut", stage, 1, save_steps=ACCUM)
            else:
                _run(root, name, stage, 1, **targs)
    finally:
        dist.destroy_process_group()


def _init_adapters(root):
    """(the start's model, LoraConfig, its adapters as `run_stage` draws
    them)."""
    cfg, model = builder.load_model(os.path.join(root, "student"),
                                    device="cpu")
    lcfg = tlora.LoraConfig(r=LORA["lora_r"], alpha=LORA["lora_alpha"],
                            dropout=0.05,
                            target_patterns=tlora.DEFAULT_TARGETS)
    lora = tlora.init_lora(model, lcfg,
                           torch.Generator().manual_seed(SEED + 1))
    return model, lcfg, lora


def _jax_metrics(root, student, jparams, teacher, jteacher, bsz):
    """JAX's single-device `make_align_step(..., lora_cfg)` on the world's
    rows, handed the port's initial adapters, with the TrainConfig
    `run_stage` derives."""
    from llavamod_tpu_torch.train import run as trun
    from llavamod_tpu_torch.train.loader import infinite_batches

    margs, dargs, extra = _stage_args(root, "align")
    targs = _targs(os.path.join(root, "unused"), bsz)
    it = infinite_batches(trun.build_data_module(
        "align", margs, dargs, targs, StubTok(), student))
    batches = [next(it) for _ in range(STEPS)]
    it.close()
    tcfg = train_config_from_args(
        "align", targs, STEPS, dataclasses.replace(
            margs, train_modules=trun.translate_train_modules(TRAIN_MODULES)),
        extra["salign"])
    jtcfg = JTrainConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(JTrainConfig)
                            if hasattr(tcfg, f.name)})
    _, lcfg, lora = _init_adapters(root)
    jcfg = jlora.LoraConfig(r=lcfg.r, alpha=lcfg.alpha, dropout=lcfg.dropout,
                            target_patterns=lcfg.target_patterns)
    flat = {k: v.numpy() for k, v in lora.state_dict().items()}

    def key(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    jl = jax.tree_util.tree_map_with_path(
        lambda path, x: jax.numpy.asarray(flat[key(path)]),
        jax.device_get(jlora.init_lora(jparams, jcfg,
                                       jax.random.PRNGKey(0))))
    step = jmake_align_step(to_jax_llava(student), to_jax_llava(teacher),
                            jtcfg, jcfg)
    # a fresh copy: the JAX step donates its state
    state = JTrainState.create(
        {"base": jax.tree_util.tree_map(jax.numpy.array, jparams),
         "lora": jl}, jtcfg, jcfg)
    out = []
    for b in batches:
        state, m = step(state, jteacher, jbatch_from_arrays(b))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 runs (spawned first, running while this
    process does the single-process and JAX references)."""
    root = str(tmp_path_factory.mktemp("lora_dist"))
    _write_data(root)
    student, jparams, teacher, jteacher = _models(root)
    cases2 = [("align", "align", {}), ("pretrain", "pretrain", {}),
              ("dpo", "dpo", {}), ("resume", "align", {})]
    cases4 = [(name, "align", mesh) for name, mesh in MESHES_4.items()]
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, cases2), (4, cases4))]
    torch.set_num_threads(1)
    for name, stage, bsz in (("single_align", "align", 2),
                             ("single_align4", "align", 4),
                             ("single_pretrain", "pretrain", 2),
                             ("single_dpo", "dpo", 2)):
        _run(root, name, stage, bsz)
    jax_metrics = {b: _jax_metrics(root, student, jparams, teacher, jteacher,
                                   b) for b in (2, 4)}
    for p in procs:
        while not p.join():
            pass
    return root, jax_metrics


def _adapters(path, model):
    return tlora.load_lora_adapter(os.path.join(path, "adapter"),
                                   model)[0].state_dict()


@pytest.mark.parametrize("mesh", ["align", *MESHES_4])
def test_lora_align_matches_single_process_and_jax(runs, mesh):
    root, jax_metrics = runs
    bsz = ROWS[mesh]
    single = "single_align" if bsz == 2 else "single_align4"
    got = _lines(os.path.join(root, mesh))
    _close(got, _lines(os.path.join(root, single)), TOL)
    _close(got, jax_metrics[bsz], TOL)
    assert got[-1]["loss"] != got[0]["loss"]
    _weights_close(root, _state(os.path.join(root, mesh)),
                   _state(os.path.join(root, single)))


@pytest.mark.parametrize("mesh", ["align", *MESHES_4])
def test_rank0_writes_the_single_process_adapter_files(runs, mesh):
    """adapter/, non_lora_trainables.bin and the merged model.pt of rank 0
    against the single-process run's: the adapters within 1e-3 of their
    move from the start, every `b` moved, the frozen weights bitwise the
    start's, each adapted weight the start plus scaling * a @ b."""
    root, _ = runs
    out = os.path.join(root, mesh)
    single = os.path.join(root, "single_align" if ROWS[mesh] == 2
                          else "single_align4")
    model, lcfg, lora0 = _init_adapters(root)
    start = lora0.state_dict()
    got, want = _adapters(out, model), _adapters(single, model)
    assert got.keys() == want.keys() == start.keys()
    for k in got:
        step = (want[k] - start[k]).norm()
        assert step > 0, k
        assert (got[k] - want[k]).norm() <= 1e-3 * step, k
    for t in lora0.targets:
        assert got[f"{t}.b"].any(), t
    extra = torch.load(os.path.join(out, "adapter", tlora.NON_LORA_FILE),
                       weights_only=True)
    ref = torch.load(os.path.join(single, "adapter", tlora.NON_LORA_FILE),
                     weights_only=True)
    assert extra.keys() == ref.keys() and any("gate.wg" in k for k in extra)
    merged, base = _state(out), _state(os.path.join(root, "student"))
    targets = set(lora0.targets)
    trained = {k for k in base if k.endswith("router")
               or k.startswith("projector.")}
    for k, v in base.items():
        if k in targets:
            pair = tlora.ParamGroup(a=got[f"{k}.a"], b=got[f"{k}.b"])
            torch.testing.assert_close(
                merged[k], tlora.merged_weight(v, pair, lcfg), rtol=1e-5,
                atol=1e-6, msg=k)
        elif k not in trained:
            assert torch.equal(merged[k], v), k
    _, loaded, _, _, _ = builder.load_pretrained_model(
        os.path.join(out, "adapter"), model_base=os.path.join(root, "student"),
        device="cpu", tokenizer=object())
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, merged[k], rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("stage", ["pretrain", "dpo"])
def test_lora_stage_1_and_3_match_single_process(runs, stage):
    root, _ = runs
    keys = (("loss", "loss/lm", "num_tokens", "grad_norm") if stage ==
            "pretrain" else ("loss", "loss/dpo", "logps/chosen",
                             "logps/rejected", "rewards/margins",
                             "loss/moe_balance", "grad_norm"))
    _close(_lines(os.path.join(root, stage)),
           _lines(os.path.join(root, f"single_{stage}")), TOL, keys)
    _weights_close(root, _state(os.path.join(root, stage)),
                   _state(os.path.join(root, f"single_{stage}")))
    assert os.path.exists(os.path.join(root, stage, "adapter",
                                       "adapter_model.bin"))


def test_lora_sharded_checkpoint_resumes_update_2(runs):
    root, _ = runs
    whole, cut = (os.path.join(root, f"resume_{p}") for p in ("whole", "cut"))
    ckpt = os.path.join(whole, f"checkpoint-{ACCUM}")
    assert "mesh.json" in os.listdir(ckpt)
    import json

    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    assert info["resumed_from"].endswith(f"checkpoint-{ACCUM}")
    assert info["microbatches"] == STEPS - ACCUM
    a, b = _lines(whole)[ACCUM:], _lines(cut)
    assert [ln["step"] for ln in b] == [ln["step"] for ln in a]
    for x, y in zip(a, b):
        for k in METRICS:
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)
    model, _, _ = _init_adapters(root)
    got, want = _adapters(cut, model), _adapters(whole, model)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7, msg=k)
    _weights_close(root, _state(cut), _state(whole), tol=1e-6)
