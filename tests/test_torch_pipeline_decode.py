"""The decoder's un-pipelined calls under pipe > 1 (llavamod_tpu_torch/
parallel/pipeline.py `sequential_layers`: a KV cache, or `scan_layers`
off) on the CPU under gloo: worlds of 2 ranks (pipe=2) and 4 ranks (pipe=2,
tensor=2) spawned with torch.multiprocessing, rendezvous through a
FileStore, the model sharded by parallel/sharding.py `shard_params`.  The
model is a tiny MoE LLaVA of 4 layers (width 64, 4 heads over 2 KV heads,
4 experts top-2 on layers 1 and 3: two layer repeats, one a stage) with the
JAX package's weights; every comparison is in f32.

  * a cached `decoder.forward` (a fresh prefill of 12 left-padded tokens,
    then 3 decode steps): the hidden of every call and the stages' caches,
    joined over the stages (and the tensor ranks' KV heads), within rel
    1e-5 of the single-process port, and the hidden within rel 1e-5 of the
    JAX package's cached `decoder.forward` under a pipe=2 mesh of the
    conftest's virtual CPU devices (JAX runs its cached path un-pipelined,
    its layers gathered by GSPMD; the XLA decode branch,
    LLAVAMOD_DECODE_ATTN=xla);
  * the cache slots: each stage's cache holds its 2 layers; a 4-slot cache
    handed to stage 1 with `first_layer` 2 is written in slots 0 and 1
    only, never in slot `layer_idx`;
  * `scan_layers` off (no cache, train mode): `router_probs` and
    `moe_losses` in layer order on every stage, and `aux_loss`, within rel
    1e-5 of JAX's un-pipelined forward and of the single-process port;
  * training with `scan_layers` off at pipe=2 (`run_stage`, stage 2b, one
    update of two rows): the first step's loss within rel 1e-5 and its
    grad_norm within rel 1e-4 of the single process;
  * the gating dump (`VQARunner` with `dump_gating`) at pipe=2 writes the
    single process's .npz and answers."""

import dataclasses
import json
import os
import shutil
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image
from test_torch_distributed import (
    StubTok,
    _lines,
    _models,
    _stage_args,
    _targs,
    _write_data,
)
from util_torch_port import matched_llava, tiny_llava_config, to_jax_llm

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.parallel.mesh import MeshConfig as JMeshConfig
from llavamod_tpu.parallel.mesh import make_mesh as jmake_mesh
from llavamod_tpu.parallel.sharding import shard_params as jshard_params
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models.llm import decoder as tdecoder

TOL = 1e-5
B, T, STEPS = 4, 12, 3
LENGTHS = [12, 9, 5, 11]
MESHES = {2: dict(pipe=2), 4: dict(pipe=2, tensor=2)}
NEW = 3


def _inputs():
    """Left-padded prompt ids, segments and positions, and the ids of the
    decode steps."""
    rng = np.random.RandomState(4)
    ids = rng.randint(2, 512, (B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    for i, n in enumerate(LENGTHS):
        seg[i, T - n:] = 1
    ids = ids * seg
    pos = np.maximum(np.cumsum(seg, 1) - 1, 0).astype(np.int32)
    steps = rng.randint(2, 512, (B, STEPS)).astype(np.int32)
    return dict(ids=ids, seg=seg, pos=pos, steps=steps,
                prompt_len=seg.sum(1).astype(np.int32))


def _cached_run(llm, cfg, arr, cache):
    """The prefill and the decode steps through the port's cached forward:
    (hidden of each call, the cache)."""
    a = {k: torch.as_tensor(v) for k, v in arr.items()}
    out = tdecoder.forward(llm, cfg, input_ids=a["ids"], positions=a["pos"],
                           segment_ids=a["seg"], cache=cache,
                           attn_impl="fresh")
    hidden = [out.hidden]
    for i in range(STEPS):
        out = tdecoder.forward(
            llm, cfg, input_ids=a["steps"][:, i:i + 1],
            positions=(a["prompt_len"] + i)[:, None],
            segment_ids=torch.ones((B, 1), dtype=torch.int32),
            cache=out.cache)
        hidden.append(out.hidden)
    return hidden, out.cache


def _no_scan(llm, cfg, arr):
    """`scan_layers` off, no cache, train mode: (hidden, aux, moe_losses,
    router_probs)."""
    out = tdecoder.forward(llm, cfg.replace(scan_layers=False),
                           input_ids=torch.as_tensor(arr["ids"]),
                           segment_ids=torch.as_tensor(arr["seg"]),
                           train=True)
    return dict(h=out.hidden, aux=out.aux_loss,
                losses=torch.stack(out.moe_losses),
                probs=torch.stack(out.router_probs))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _decoder_case(rank, root, world):
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.sharding import gathered, shard_params

    cfg, model = builder.load_model(os.path.join(root, "model"),
                                    device="cpu")
    pctx = ParallelContext(make_mesh(MeshConfig(**MESHES[world]), "cpu"))
    shard_params(pctx.mesh, model, ctx=pctx)
    arr = dict(np.load(os.path.join(root, "inputs.npz")))
    llm = model.llm
    with active(pctx), torch.no_grad(), gathered(model):
        cache = tdecoder.init_cache(cfg.llm, B, T + STEPS,
                                    dtype=torch.float32)
        hidden, cache = _cached_run(llm, cfg.llm, arr, cache)
        # stage 1 handed a cache of every layer's slots, slot 0 its first
        probe = tdecoder.init_cache(cfg.llm, B, T + STEPS,
                                    dtype=torch.float32)
        if pctx.pipe_rank == 1:
            whole = torch.zeros((4,) + tuple(probe.k.shape[1:]))
            probe = probe._replace(k=whole, v=whole.clone(), first_layer=2)
        out = tdecoder.forward(
            llm, cfg.llm, input_ids=torch.as_tensor(arr["ids"]),
            positions=torch.as_tensor(arr["pos"]),
            segment_ids=torch.as_tensor(arr["seg"]), cache=probe,
            attn_impl="fresh")
        no_scan = _no_scan(llm, cfg.llm, arr)
    torch.save(dict(hidden=hidden, k=cache.k, v=cache.v,
                    first_layer=cache.first_layer, length=cache.length,
                    probe_k=out.cache.k, stage=pctx.pipe_rank,
                    tensor_rank=pctx.tensor_rank, layers=llm.layers.indices,
                    no_scan=no_scan),
               os.path.join(root, f"dec{world}_rank{rank}.pt"))


def _train_case(rank, root):
    from llavamod_tpu_torch.train import run as trun

    margs, dargs, extra = _stage_args(root, "align", "student_noscan")
    trun.run_stage("align", margs, dargs,
                   _targs(os.path.join(root, "pp_noscan"), 2, max_steps=1,
                          gradient_accumulation_steps=1,
                          pipeline_parallel=2),
                   tokenizer=StubTok(), device="cpu", **extra)


def _gating_case(rank, root):
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.sharding import shard_params

    cfg, model = builder.load_model(os.path.join(root, "model"),
                                    device="cpu")
    pctx = ParallelContext(make_mesh(MeshConfig(pipe=2), "cpu"))
    shard_params(pctx.mesh, model, ctx=pctx)
    with active(pctx):
        _run_vqa(model, root, f"pp{rank}")


def _world(rank, world, store, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        _decoder_case(rank, root, world)
        if world == 2:
            _gating_case(rank, root)
            _train_case(rank, root)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

class CharTok:
    """One id per character of the last 24 characters of a text (ids within
    the tiny vocab) (tests/test_torch_eval_generate.py's)."""
    pad_token_id = 0
    eos_token_id = None

    def __call__(self, text):
        return types.SimpleNamespace(
            input_ids=[(ord(c) % 200) + 5 for c in text[-24:]])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + (int(i) % 26)) for i in ids)


def _run_vqa(model, root, tag):
    """`VQARunner.run` with the gating dump on two questions, one batch."""
    from llavamod_tpu_torch.eval import generate as teval
    from llavamod_tpu_torch.generation import GenerationConfig

    questions = [{"question_id": f"q{i}", "text": f"what is shown {i}?",
                  "image": f"{i}.png"} for i in range(2)]
    runner = teval.VQARunner(
        model, CharTok(), builder.make_image_preprocessor(model.cfg),
        template_name="qwen", batch_size=2, max_prompt_len=64,
        model_id="tiny",
        dump_gating=os.path.join(root, f"{tag}_gating.npz"))
    gcfg = GenerationConfig(max_new_tokens=NEW, pad_token_id=0,
                            cache_dtype="float32")
    rows = runner.run(questions, root, os.path.join(root, f"{tag}.jsonl"),
                      gcfg)
    return [{k: v for k, v in r.items() if k != "answer_id"} for r in rows]


def _jax_decoder(params, cfg, arr):
    """JAX's cached forward under a pipe=2 mesh (prefill and decode steps:
    the hidden of each call) and its un-pipelined forward with
    `scan_layers` off (no mesh)."""
    jcfg = to_jax_llm(cfg)

    def prefill(p, c):
        return jdecoder.forward(
            p, jcfg, input_ids=jnp.asarray(arr["ids"]),
            positions=jnp.asarray(arr["pos"]),
            segment_ids=jnp.asarray(arr["seg"]), cache=c, attn_impl="fresh")

    def step(p, c, ids, pos):
        return jdecoder.forward(p, jcfg, input_ids=ids, positions=pos,
                                segment_ids=jnp.ones((B, 1), jnp.int32),
                                cache=c)

    old = os.environ.get("LLAVAMOD_DECODE_ATTN")
    os.environ["LLAVAMOD_DECODE_ATTN"] = "xla"
    try:
        mesh = jmake_mesh(JMeshConfig(pipe=2), jax.devices()[:2])
        with jax.set_mesh(mesh):
            p = jshard_params(mesh, params)
            out = jax.jit(prefill)(p, jdecoder.init_cache(
                jcfg, B, T + STEPS, jnp.float32))
            hidden = [np.asarray(out.hidden)]
            step = jax.jit(step)
            for i in range(STEPS):
                out = step(p, out.cache, jnp.asarray(arr["steps"][:, i:i + 1]),
                           jnp.asarray(arr["prompt_len"] + i)[:, None])
                hidden.append(np.asarray(out.hidden))
    finally:
        if old is None:
            os.environ.pop("LLAVAMOD_DECODE_ATTN")
        else:
            os.environ["LLAVAMOD_DECODE_ATTN"] = old
    ncfg = dataclasses.replace(jcfg, scan_layers=False)
    ns = jax.jit(lambda p: jdecoder.forward(
        p, ncfg, input_ids=jnp.asarray(arr["ids"]),
        segment_ids=jnp.asarray(arr["seg"]), train=True))(params)
    return dict(hidden=hidden, no_scan=dict(
        h=np.asarray(ns.hidden), aux=float(ns.aux_loss),
        losses=np.stack([np.asarray(a) for a in ns.moe_losses]),
        probs=np.stack([np.asarray(a) for a in ns.router_probs])))


def _noscan_student(root):
    """A copy of tests/test_torch_distributed.py's student with
    `scan_layers` off."""
    shutil.copytree(os.path.join(root, "student"),
                    os.path.join(root, "student_noscan"))
    path = os.path.join(root, "student_noscan", builder.CONFIG_NAME)
    with open(path) as f:
        saved = json.load(f)
    saved["llm"]["scan_layers"] = False
    with open(path, "w") as f:
        json.dump(saved, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds (spawned first, running while this process computes the
    single-process and JAX references)."""
    from llavamod_tpu_torch.train import run as trun

    root = str(tmp_path_factory.mktemp("ppdec"))
    cfg = tiny_llava_config(num_layers=4, moe_layers=(1, 3))
    _, params, model = matched_llava(cfg, seed=3)
    builder.save_model(os.path.join(root, "model"), model)
    arr = _inputs()
    np.savez(os.path.join(root, "inputs.npz"), **arr)
    rng = np.random.RandomState(6)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (40, 30, 3), dtype=np.uint8)
                        ).save(os.path.join(root, f"{i}.png"))
    _write_data(root)
    _models(root)
    _noscan_student(root)
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root),
                      nprocs=w, join=False) for w in MESHES]
    torch.set_num_threads(1)
    with torch.no_grad():
        cache = tdecoder.init_cache(cfg.llm, B, T + STEPS,
                                    dtype=torch.float32)
        hidden, cache = _cached_run(model.llm, cfg.llm, arr, cache)
        single = dict(hidden=hidden, k=cache.k, v=cache.v,
                      no_scan=_no_scan(model.llm, cfg.llm, arr))
    single["vqa"] = _run_vqa(model, root, "single")
    margs, dargs, extra = _stage_args(root, "align", "student_noscan")
    trun.run_stage("align", margs, dargs,
                   _targs(os.path.join(root, "single_noscan"), 2,
                          max_steps=1, gradient_accumulation_steps=1),
                   tokenizer=StubTok(), device="cpu", **extra)
    want = _jax_decoder(params["llm"], cfg.llm, arr)
    for p in procs:
        while not p.join():
            pass
    return root, single, want


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a, np.float64))
    b = torch.as_tensor(np.asarray(b, np.float64))
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _ranks(root, world):
    return [torch.load(os.path.join(root, f"dec{world}_rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def _joined(ranks, key):
    """The stages' caches joined over the layers, the tensor ranks' over
    the KV heads."""
    stages = {}
    for r in sorted(ranks, key=lambda r: (r["stage"], r["tensor_rank"])):
        stages.setdefault(r["stage"], []).append(r[key])
    return torch.cat([torch.cat(stages[s], dim=2) for s in sorted(stages)])


@pytest.mark.parametrize("world", list(MESHES))
def test_cached_forward_under_the_pipeline_matches_single_process_and_jax(
        runs, world):
    root, single, want = runs
    ranks = _ranks(root, world)
    for r in ranks:
        assert len(r["hidden"]) == STEPS + 1
        for i, (h, s, j) in enumerate(zip(r["hidden"], single["hidden"],
                                          want["hidden"])):
            assert _rel(h, s) <= TOL, (r["stage"], i, "single")
            assert _rel(h, j) <= TOL, (r["stage"], i, "jax")
        assert r["length"] == T + STEPS
    for key in ("k", "v"):
        got = _joined(ranks, key)
        assert got.shape == single[key].shape
        assert _rel(got, single[key]) <= TOL, key


@pytest.mark.parametrize("world", list(MESHES))
def test_each_stage_cache_holds_its_own_layers(runs, world):
    root, _, _ = runs
    tp = MESHES[world].get("tensor", 1)
    for r in _ranks(root, world):
        stage = r["stage"]
        assert r["layers"] == [2 * stage, 2 * stage + 1]
        assert r["first_layer"] == 2 * stage
        assert tuple(r["k"].shape) == (2, B, 2 // tp, T + STEPS, 16)


def test_stage_1_writes_its_own_slots_and_never_slot_layer_idx(runs):
    """Stage 1 runs layers 2 and 3: handed a cache of 4 slots whose slot 0
    is layer 2, it writes slots 0 and 1 (what its own cache holds after the
    same prefill) and leaves slots 2 and 3, its layers' indices, empty."""
    root, _, _ = runs
    stage1 = [r for r in _ranks(root, 2) if r["stage"] == 1][0]
    probe, own = stage1["probe_k"], stage1["k"]
    assert probe.shape[0] == 4
    np.testing.assert_array_equal(probe[:2, :, :, :T].numpy(),
                                  own[:, :, :, :T].numpy())
    assert probe[:2].abs().sum() > 0
    assert not probe[2:].any()


@pytest.mark.parametrize("world", list(MESHES))
def test_scan_layers_off_returns_the_router_probes_in_layer_order(runs,
                                                                  world):
    root, single, want = runs
    w, s = want["no_scan"], single["no_scan"]
    assert w["probs"].shape == (2, B * T, 4)
    for r in _ranks(root, world):
        got = r["no_scan"]
        assert got["probs"].shape == w["probs"].shape
        for i in range(2):          # layers 1 and 3
            assert _rel(got["probs"][i], w["probs"][i]) <= TOL, i
            assert _rel(got["probs"][i], s["probs"][i]) <= TOL, i
        assert _rel(got["losses"], w["losses"]) <= TOL
        assert _rel(got["losses"], s["losses"]) <= TOL
        assert float(got["aux"]) == pytest.approx(w["aux"], rel=TOL)
        assert float(got["aux"]) == pytest.approx(float(s["aux"]), rel=TOL)
        assert _rel(got["h"], w["h"]) <= TOL


def test_training_with_scan_layers_off_matches_single_process(runs):
    root, _, _ = runs
    got = _lines(os.path.join(root, "pp_noscan"))
    want = _lines(os.path.join(root, "single_noscan"))
    assert len(got) == len(want) == 1
    assert got[0]["loss/moe_balance"] > 0
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"],
                               rtol=1e-4)
    with open(os.path.join(root, "pp_noscan", "run_info.json")) as f:
        assert json.load(f)["mesh"]["pipe"] == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_gating_dump_under_the_pipeline_is_the_single_process_dump(runs,
                                                                   rank):
    root, single, _ = runs
    want = np.load(os.path.join(root, "single_gating.npz"))
    got = np.load(os.path.join(root, f"pp{rank}_gating.npz"))
    assert sorted(got.files) == sorted(want.files) == ["q0", "q1"]
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].shape[0] == 2
        np.testing.assert_array_equal(got[k], want[k])
    with open(os.path.join(root, f"pp{rank}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [{k: v for k, v in r.items() if k != "answer_id"}
            for r in rows] == single["vqa"]
