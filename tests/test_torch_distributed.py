"""Multi-process training of the port (llavamod_tpu_torch/parallel/,
train/run.py under torch.distributed) on the CPU under gloo: 2 and 4 ranks
spawned with torch.multiprocessing, rendezvous through a FileStore, one
row per rank, so the world's rows in rank order are the single-process
batch.  The model is a tiny LLaVA-MoD (2 layers, width 64, 4 experts top-2
on both layers, vocab 512, capacity factor 1.0, so the gate drops tokens)
distilled from a tiny dense teacher; weights carried from the JAX
package's init by interop/from_jax.py.

  * stage 2b (`run_stage("align")`, kd_lm, the record train set, AdamW,
    accumulation 2: 2 updates) at world 2 (fsdp=2) and world 4 (data=2,
    expert=2; fsdp=2, expert=2) logs, microbatch for microbatch, the
    losses and grad_norm of the single-process port on the same global
    batch and of the JAX package's single-device `make_align_step` on it
    (rel 2e-4 in f32, JAX's own tolerance for its mesh,
    tests/test_parallel.py:116-119), and rank 0's `model.pt` holds the
    single-process run's weights;
  * the ungrouped gate is the world's: gating each rank's tokens alone
    drops other tokens and logs another loss; grouped gating whose groups
    straddle the ranks gates the world's tokens in the single-process
    groups; the token means divide by the world's counts: the ranks hold
    different numbers of valid tokens, and rank-local denominators log
    another loss;
  * the sharded checkpoint after update 1, or in the middle of update 2
    (torch.distributed.checkpoint, every rank's shards), resumes to the
    same update 2 and final weights;
  * stage 1 (projector only) and stage 3 (kto_pair) at world 2 against
    the single-process port; `--optimizer adafactor` at world 2 against
    the single-process port, and one Adafactor update of a factored
    [256, 128] parameter sharded over 2 ranks against the whole one."""

import json
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from util_torch_port import matched_llava, tiny_llava_config, to_jax_llava

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.optim import TrainState as JTrainState
from llavamod_tpu.train.steps import (
    batch_from_arrays as jbatch_from_arrays,
    make_align_step as jmake_align_step,
)
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.train.args import (
    AlignArgs,
    DataArgs,
    DPOArgs,
    ModelArgs,
    TrainArgs,
    train_config_from_args,
)

TOL = 2e-4
METRICS = ("loss", "loss/align", "loss/lm", "loss/moe_balance", "grad_norm")
STEPS, ACCUM = 4, 2
GROUP = 96     # divides neither a rank's 256 tokens nor the world's 512
TRAIN_MODULES = ["mlp.gate_proj", "mlp.up_proj", "mlp.down_proj", "wg"]
MESHES_4 = {"data2_expert2": dict(data_parallel=2, expert_parallel=2),
            "fsdp2_expert2": dict(expert_parallel=2)}


class StubTok:
    """Character-level ids, no BOS."""
    bos_token_id = None
    pad_token_id = 0

    def __call__(self, text):
        return type("R", (), {"input_ids": [ord(c) % 500 for c in text]})()


def _write_data(root, n=12):
    """Samples of different lengths, so the ranks of a step hold different
    numbers of valid tokens."""
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    sft, pref = [], []
    for i in range(n):
        name = f"img{i}.png"
        Image.new("RGB", (28, 28), (i * 20 % 255, 60, 90)).save(
            os.path.join(img_dir, name))
        human = {"from": "human",
                 "value": "<image>\nwhat is this?" + " and" * (i % 4)}
        answer = {"from": "gpt", "value": f"a bus {i}" + " red" * (i % 5)}
        sft.append({"image": name, "conversations": [human, answer]})
        pref.append({"image": name, "chosen": [human, answer],
                     "rejected": [human, {"from": "gpt",
                                          "value": "no" * (1 + i % 3)}]})
    for name, rows in (("sft.json", sft), ("dpo.json", pref)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(rows, f)


def _models(root):
    """(student cfg, JAX student params, teacher cfg, JAX teacher params
    without its tower); both saved in the port's format."""
    student = tiny_llava_config(moe_num_experts=4, moe_layers=(0, 1),
                                moe_capacity_factor=1.0)
    _, jparams, model = matched_llava(student, seed=0)
    builder.save_model(os.path.join(root, "student"), model)
    # the same weights, gated in groups of GROUP tokens
    grouped = os.path.join(root, "student_grouped")
    shutil.copytree(os.path.join(root, "student"), grouped)
    with open(os.path.join(grouped, builder.CONFIG_NAME)) as f:
        saved = json.load(f)
    saved["llm"]["moe_gating_group_size"] = GROUP
    with open(os.path.join(grouped, builder.CONFIG_NAME), "w") as f:
        json.dump(saved, f)
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", hidden_size=96, intermediate_size=160,
        num_heads=4, num_kv_heads=4, moe_num_experts=0, moe_layers=()))
    jteacher = jllava.init(to_jax_llava(teacher), jax.random.PRNGKey(7))
    tmodel = tllava.init(teacher, torch.Generator().manual_seed(7))
    load_jax_params(tmodel, jax.device_get(jteacher))
    builder.save_model(os.path.join(root, "teacher"), tmodel)
    return student, jparams, teacher, {k: v for k, v in jteacher.items()
                                       if k != "vision"}


def _targs(out, bsz, **kw):
    base = dict(output_dir=out, per_device_train_batch_size=bsz,
                max_steps=STEPS, gradient_accumulation_steps=ACCUM,
                logging_steps=1, save_steps=100, model_max_length=256,
                dataloader_num_workers=0, compute_dtype="float32",
                remat=False, vocab_chunk=128, learning_rate=1e-3,
                warmup_ratio=0.0, group_by_modality_length=False)
    base.update(kw)
    return TrainArgs(**base)


def _stage_args(root, stage, student="student"):
    """(stage, ModelArgs, DataArgs, extra kwargs of run_stage)."""
    imgs = os.path.join(root, "imgs")
    if stage == "pretrain":
        return (ModelArgs(model_name_or_path=os.path.join(root, "student"),
                          version="plain", tune_mm_mlp_adapter=True),
                DataArgs(data_path=[os.path.join(root, "sft.json")],
                         image_folder=imgs), {})
    if stage == "dpo":
        return (ModelArgs(version="qwen"),
                DataArgs(data_path=[os.path.join(root, "dpo.json")],
                         image_folder=imgs),
                dict(sdpo=DPOArgs(
                    policy_model_name_or_path=os.path.join(root, "student"),
                    ref_model_name_or_path=os.path.join(root, "teacher"),
                    loss_type="kto_pair", moe_loss_enable=True)))
    return (ModelArgs(version="qwen", train_modules=TRAIN_MODULES),
            DataArgs(data_path=[os.path.join(root, "sft.json")],
                     image_folder=imgs),
            dict(salign=AlignArgs(
                policy_model_name_or_path=os.path.join(root, student),
                ref_model_name_or_path=os.path.join(root, "teacher"),
                policy_model_type="sparse", loss_type="kd_lm",
                moe_loss_enable=True)))


def _run(root, name, stage, bsz, student="student", **targs):
    from llavamod_tpu_torch.train import run as trun

    margs, dargs, extra = _stage_args(root, stage, student)
    return trun.run_stage(stage, margs, dargs,
                          _targs(os.path.join(root, name), bsz, **targs),
                          tokenizer=StubTok(), device="cpu", **extra)


def _adafactor_leaf(rank, world, root):
    """One Adafactor update of a factored [256, 128] parameter whose dim 0
    is split over the ranks, against the update of the whole one."""
    from llavamod_tpu_torch.train import adafactor

    g = torch.Generator().manual_seed(3)
    p, grad = torch.randn(256, 128, generator=g), torch.randn(256, 128,
                                                              generator=g)
    whole, _ = adafactor.update_leaf(p, grad, adafactor.init_leaf(p), 0, 1e-2)
    rows = slice(rank * 128, (rank + 1) * 128)
    shards = ((256, 128), {0: [(dist.group.WORLD, world)]})
    mine, state = adafactor.update_leaf(
        p[rows], grad[rows], adafactor.init_leaf(p[rows], (256, 128)), 0,
        1e-2, shards=shards)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    if rank == 0:
        torch.save({"whole": whole, "sharded": torch.cat(parts),
                    "v_row": state["v_row"].shape,
                    "v_col": state["v_col"].shape},
                   os.path.join(root, "adafactor_leaf.pt"))


def _world(rank, world, store, root, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from llavamod_tpu_torch.parallel.collectives import ParallelContext

    try:
        for name, stage, targs in cases:
            if name == "local_gate":       # every rank gates its own tokens
                orig = ParallelContext.gather_rows
                ParallelContext.gather_rows = lambda self, x: (
                    x, torch.arange(x.shape[0]))
                try:
                    _run(root, name, stage, 1, **targs)
                finally:
                    ParallelContext.gather_rows = orig
            elif name == "local_counts":   # every rank divides by its own
                orig = ParallelContext.all_sum
                ParallelContext.all_sum = lambda self, x: x
                try:
                    _run(root, name, stage, 1, **targs)
                finally:
                    ParallelContext.all_sum = orig
            elif name.startswith("resume"):   # resume_<checkpoint step>
                at = int(name.split("_")[1])
                whole, cut = (os.path.join(root, f"{name}_{part}")
                              for part in ("whole", "cut"))
                _run(root, os.path.basename(whole), stage, 1, save_steps=at)
                if rank == 0:
                    shutil.copytree(os.path.join(whole, f"checkpoint-{at}"),
                                    os.path.join(cut, f"checkpoint-{at}"))
                dist.barrier()
                _run(root, os.path.basename(cut), stage, 1, save_steps=at)
            elif name == "adafactor_leaf":
                _adafactor_leaf(rank, world, root)
            else:
                _run(root, name, stage, 1, **targs)
    finally:
        dist.destroy_process_group()


def _lines(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state(path):
    return torch.load(os.path.join(path, "model.pt"), weights_only=True)


def _jax_metrics(root, student, jparams, teacher, jteacher, bsz):
    """JAX's single-device make_align_step on the global batches the
    single-process loader of `bsz` rows gives (the world's rows in rank
    order), with the TrainConfig `run_stage` derives."""
    import dataclasses

    from llavamod_tpu_torch.train import run as trun
    from llavamod_tpu_torch.train.loader import infinite_batches

    margs, dargs, extra = _stage_args(root, "align")
    targs = _targs(os.path.join(root, "unused"), bsz)
    loader = trun.build_data_module("align", margs, dargs, targs, StubTok(),
                                    student)
    it = infinite_batches(loader)
    batches = [next(it) for _ in range(STEPS)]
    it.close()
    tcfg = train_config_from_args(
        "align", targs, STEPS, dataclasses.replace(
            margs, train_modules=trun.translate_train_modules(TRAIN_MODULES)),
        extra["salign"])
    jtcfg = JTrainConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(JTrainConfig)
                            if hasattr(tcfg, f.name)})
    step = jmake_align_step(to_jax_llava(student), to_jax_llava(teacher),
                            jtcfg)
    # a fresh copy: the JAX step donates its state
    state = JTrainState.create(jax.tree_util.tree_map(jax.numpy.array,
                                                      jparams), jtcfg)
    out = []
    for b in batches:
        state, m = step(state, jteacher, jbatch_from_arrays(b))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 runs (spawned first, running while this
    process does the single-process and JAX references)."""
    root = str(tmp_path_factory.mktemp("dist"))
    _write_data(root)
    student, jparams, teacher, jteacher = _models(root)
    cases2 = [("align", "align", {}), ("local_gate", "align", {}),
              ("local_counts", "align", {}),
              ("grouped", "align", dict(student="student_grouped")),
              (f"resume_{ACCUM}", "align", {}), ("resume_3", "align", {}),
              ("pretrain", "pretrain", {}), ("dpo", "dpo", {}),
              ("adafactor", "align", dict(optimizer="adafactor")),
              ("adafactor_leaf", None, {})]
    cases4 = [(name, "align", mesh) for name, mesh in MESHES_4.items()]
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, cases2), (4, cases4))]
    torch.set_num_threads(1)
    for name, stage, bsz, targs in (
            ("single_align", "align", 2, {}),
            ("single_align4", "align", 4, {}),
            ("single_grouped", "align", 2, dict(student="student_grouped")),
            ("single_pretrain", "pretrain", 2, {}),
            ("single_dpo", "dpo", 2, {}),
            ("single_adafactor", "align", 2, dict(optimizer="adafactor"))):
        _run(root, name, stage, bsz, **targs)
    jax_metrics = {b: _jax_metrics(root, student, jparams, teacher, jteacher,
                                   b) for b in (2, 4)}
    for p in procs:
        while not p.join():
            pass
    return root, jax_metrics


def _close(got, want, tol, keys=METRICS):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=tol,
                                           err_msg=f"microbatch {i} {k}")


def _weights_close(root, a, b, tol=1e-3):
    """The weights `a` and `b` trained from the student's: every tensor's
    distance within `tol` of `b`'s own move from the start (AdamW's
    normalised step moves an entry whose gradient is near zero by a
    sizeable part of lr whatever its rounding), and the tensors that did
    not move bitwise equal."""
    init = _state(os.path.join(root, "student"))
    assert a.keys() == b.keys() == init.keys()
    moved = 0
    for k in a:
        x, y = a[k].double(), b[k].double()
        step = (y - init[k].double()).norm()
        if step == 0:
            assert torch.equal(a[k], b[k]), k
        else:
            moved += 1
            assert (x - y).norm() <= tol * step, k
    assert moved


@pytest.mark.parametrize("mesh", ["fsdp2", *MESHES_4])
def test_align_matches_single_process_and_jax(runs, mesh):
    root, jax_metrics = runs
    name, single, bsz = (("align", "single_align", 2) if mesh == "fsdp2"
                         else (mesh, "single_align4", 4))
    got = _lines(os.path.join(root, name))
    _close(got, _lines(os.path.join(root, single)), TOL)
    _close(got, jax_metrics[bsz], TOL)
    with open(os.path.join(root, name, "run_info.json")) as f:
        info = json.load(f)
    assert info["optimizer_updates"] == STEPS // ACCUM
    assert info["mesh"] == dict(
        data=2 if mesh == "data2_expert2" else 1,
        fsdp=2 if mesh != "data2_expert2" else 1,
        expert=1 if mesh == "fsdp2" else 2, tensor=1, pipe=1)
    assert got[0]["loss/moe_balance"] > 0 and got[-1]["loss"] != got[0][
        "loss"]
    _weights_close(root, _state(os.path.join(root, name)),
                   _state(os.path.join(root, single)))


def test_gating_is_global_and_drops_tokens(runs, monkeypatch):
    """The world's tokens are gated as one set: the first global batch
    drops tokens at capacity factor 1.0, and gating each rank's tokens
    alone changes which, and the loss."""
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.train import run as trun
    from llavamod_tpu_torch.train.loader import infinite_batches
    from llavamod_tpu_torch.train.steps import batch_from_arrays

    root, _ = runs
    cfg, model = builder.load_model(os.path.join(root, "student"),
                                    device="cpu")
    margs, dargs, _ = _stage_args(root, "align")
    it = infinite_batches(trun.build_data_module(
        "align", margs, dargs, _targs(os.path.join(root, "unused"), 2),
        StubTok(), cfg))
    batch = batch_from_arrays(next(it), device="cpu")
    it.close()
    seen = []
    gate = decoder.top_k_gating_compact

    def spy(logits, gcfg, *, train, token_valid):
        out = gate(logits, gcfg, train=train, token_valid=token_valid)
        seen.append((int(out.kept.sum()), int(token_valid.sum()) * gcfg.top_k))
        return out

    monkeypatch.setattr(decoder, "top_k_gating_compact", spy)
    with torch.no_grad():
        model(batch, train=True, attn_impl="xla")
    assert len(seen) == 2 and any(kept < routed for kept, routed in seen)

    single = _lines(os.path.join(root, "single_align"))
    local = _lines(os.path.join(root, "local_gate"))
    assert abs(local[0]["loss/moe_balance"] - single[0]["loss/moe_balance"]) \
        > 1e-3 * single[0]["loss/moe_balance"]
    assert abs(local[0]["loss"] - single[0]["loss"]) > 1e-5 * single[0]["loss"]
    _close(_lines(os.path.join(root, "align")), single, TOL)


def test_grouped_gating_straddling_the_ranks_matches_single_process(runs):
    """Gating groups of GROUP tokens that cross the ranks' rows (and pad
    the world's tokens at their end) are the single process's groups: the
    world-2 run logs the single-process losses, and they differ from the
    ungrouped gate's."""
    root, _ = runs
    got = _lines(os.path.join(root, "grouped"))
    want = _lines(os.path.join(root, "single_grouped"))
    _close(got, want, TOL)
    ungrouped = _lines(os.path.join(root, "single_align"))
    assert abs(want[0]["loss/moe_balance"] - ungrouped[0]["loss/moe_balance"]
               ) > 1e-3 * ungrouped[0]["loss/moe_balance"]
    _weights_close(root, _state(os.path.join(root, "grouped")),
                   _state(os.path.join(root, "single_grouped")))


def test_token_means_divide_by_the_world_count(runs):
    """The two ranks of a step hold different numbers of valid tokens; the
    logged num_tokens is the world's, and rank-local denominators log
    another loss."""
    root, _ = runs
    one = _lines(os.path.join(root, "single_pretrain"))     # per-row counts
    single = _lines(os.path.join(root, "single_align"))
    dist_ = _lines(os.path.join(root, "align"))
    local = _lines(os.path.join(root, "local_counts"))
    assert [ln["num_tokens"] for ln in dist_] == [ln["num_tokens"]
                                                  for ln in single]
    assert len({ln["num_tokens"] for ln in one}) > 1
    assert abs(local[0]["loss/align"] - single[0]["loss/align"]) > \
        1e-4 * abs(single[0]["loss/align"])


@pytest.mark.parametrize("at", [ACCUM, 3], ids=["update_boundary",
                                                "mid_accumulation"])
def test_sharded_checkpoint_resumes_update_2(runs, at):
    """A run resumed from the sharded checkpoint after update 1 (or after
    the first microbatch of update 2, the accumulator saved) logs update
    2's microbatches and ends with the weights of the uninterrupted run."""
    root, _ = runs
    whole = os.path.join(root, f"resume_{at}_whole")
    cut = os.path.join(root, f"resume_{at}_cut")
    ckpt = os.path.join(whole, f"checkpoint-{at}")
    files = sorted(os.listdir(ckpt))
    assert ".metadata" in files and "mesh.json" in files
    # every rank wrote its own files (__<rank>_<writer thread>.distcp)
    assert {f.split("_")[2] for f in files if f.endswith(".distcp")} == {
        "0", "1"}
    with open(os.path.join(ckpt, "mesh.json")) as f:
        assert json.load(f)["accumulator"] == (at % ACCUM != 0)
    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    assert info["resumed_from"].endswith(f"checkpoint-{at}")
    assert info["microbatches"] == STEPS - at
    assert info["optimizer_updates"] == STEPS // ACCUM
    a, b = _lines(whole)[at:], _lines(cut)
    assert [ln["step"] for ln in b] == [ln["step"] for ln in a]
    for x, y in zip(a, b):
        for k in METRICS:
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)
    _weights_close(root, _state(cut), _state(whole), tol=1e-6)


def test_rank0_model_pt_loads_single_process(runs):
    root, _ = runs
    out = os.path.join(root, "align")
    cfg, model = builder.load_model(out, device="cpu")
    assert cfg.llm.moe_num_experts == 4
    want = _state(os.path.join(root, "single_align"))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert got["llm.layers.0.mlp.experts.up"].shape[0] == 4   # all experts


@pytest.mark.parametrize("stage", ["pretrain", "dpo"])
def test_stage_1_and_3_match_single_process(runs, stage):
    root, _ = runs
    got = _lines(os.path.join(root, stage))
    want = _lines(os.path.join(root, f"single_{stage}"))
    keys = (("loss", "loss/lm", "num_tokens", "grad_norm") if stage ==
            "pretrain" else ("loss", "loss/dpo", "logps/chosen",
                             "logps/rejected", "rewards/margins",
                             "loss/moe_balance", "grad_norm"))
    _close(got, want, TOL, keys)
    _weights_close(root, _state(os.path.join(root, stage)),
                   _state(os.path.join(root, f"single_{stage}")))
    if stage == "pretrain":
        assert os.path.exists(os.path.join(root, stage, "mm_projector.bin"))


def test_adafactor_matches_single_process(runs):
    root, _ = runs
    _close(_lines(os.path.join(root, "adafactor")),
           _lines(os.path.join(root, "single_adafactor")), TOL)
    leaf = torch.load(os.path.join(root, "adafactor_leaf.pt"),
                      weights_only=True)
    assert tuple(leaf["v_row"]) == (128,) and tuple(leaf["v_col"]) == (128,)
    np.testing.assert_allclose(leaf["sharded"].numpy(), leaf["whole"].numpy(),
                               rtol=1e-5, atol=1e-7)
