"""Generation of the port under a (data, fsdp, expert, tensor) mesh on the
CPU under gloo: worlds of 2 and 8 ranks spawned with torch.multiprocessing,
rendezvous through a FileStore, the model sharded by parallel/sharding.py
`shard_params` (FSDP2, expert slices, tensor slices) and `generate` run
under the mesh's context, each rank on its row rank's rows (the ranks of a
tensor group hold the same rows).  The model is a tiny MoE LLaVA (2
layers, width 64, 4 heads over 2 KV heads, 4 experts top-2) with the JAX
package's weights, the batch left-padded with and without images, as in
tests/test_torch_generation.py; the JAX side decodes through its XLA branch
(LLAVAMOD_DECODE_ATTN=xla), which changes nothing in the JAX package.

  * greedy `generate` at (tensor=2), (tensor=2 with seq_shard_activations)
    and (fsdp=2, expert=2, tensor=2) over 8 ranks emits the single-process
    port's tokens and JAX's unsharded `generate`'s (as
    tests/test_parallel.py holds the JAX package's mesh generation to its
    unsharded one);
  * the int8 KV cache at tensor=2 emits the single-process port's int8
    tokens; `generate_stream` at tensor=2 concatenates to `generate`;
  * sampling at temperature 1 with a differently seeded generator on each
    rank gives one token per row on both tensor ranks (tensor rank 0's);
  * the cache holds the rank's KH / tensor KV heads, and the decode
    attention sees them;
  * under pipe=2 (2 ranks) and (pipe=2, tensor=2) (4 ranks), with a 4-layer
    MoE LLaVA (MoE on layers 1 and 3: pipe=2 needs two layer repeats),
    greedy and int8-cache tokens equal the single-process port's and JAX's
    unsharded `generate`'s, `generate_stream` concatenates to them, sampled
    tokens agree over the pipe group (pipe rank 0's), and each rank's cache
    holds its stage's 2 layers, on which K2 runs each decode step."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from util_torch_port import (
    jax_batch,
    matched_llava,
    multimodal_arrays,
    tiny_llava_config,
    torch_batch,
)

from llavamod_tpu import generation as jgen
from llavamod_tpu_torch import generation as tgen
from llavamod_tpu_torch.models import builder

NEW = 6
LENGTHS = [16, 11, 5, 14]
WITH_IMAGE = [True, False, True, True]
T = 20
TP2 = dict(tensor=2)
CASES2 = {"tp": (TP2, {}, False, "generate"),
          "tp_sp": (TP2, {}, True, "generate"),
          "tp_int8": (TP2, dict(cache_dtype="int8"), False, "generate"),
          "tp_stream": (TP2, {}, False, "stream"),
          "tp_sample": (TP2, dict(temperature=1.0), False, "generate")}
CASES8 = {"fsdp2_expert2_tp2": (dict(fsdp=2, expert=2, tensor=2), {}, False,
                                "generate")}
# the pipeline's cases run the 4-layer model ("model4")
PP2 = dict(pipe=2)
CASES_PP2 = {"pp2": (PP2, {}, False, "generate", "model4"),
             "pp2_int8": (PP2, dict(cache_dtype="int8"), False, "generate",
                          "model4"),
             "pp2_stream": (PP2, {}, False, "stream", "model4"),
             "pp2_sample": (PP2, dict(temperature=1.0), False, "generate",
                            "model4")}
CASES_PP4 = {"pp2_tp2": (dict(pipe=2, tensor=2), {}, False, "generate",
                         "model4")}
WORLDS = {name: w for w, cases in ((2, CASES2), (8, CASES8), (2, CASES_PP2),
                                   (4, CASES_PP4)) for name in cases}


def _gcfg(**kw):
    base = dict(max_new_tokens=NEW, cache_dtype="float32")
    base.update(kw)
    return tgen.GenerationConfig(**base)


def _case(rank, root, name, mesh_kw, gkw, seq, how, model_dir="model"):
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.sharding import shard_params
    from llavamod_tpu_torch.train.steps import _row_chunk

    cfg, model = builder.load_model(os.path.join(root, model_dir),
                                    device="cpu")
    if seq:
        cfg = cfg.replace(llm=cfg.llm.replace(seq_shard_activations=True))
        model.cfg, model.llm.cfg = cfg, cfg.llm
    pctx = ParallelContext(make_mesh(MeshConfig(**mesh_kw), "cpu"))
    shard_params(pctx.mesh, model, ctx=pctx)
    arrays = dict(np.load(os.path.join(root, "batch.npz")))
    n = len(LENGTHS) // pctx.rows
    batch = _row_chunk(torch_batch(arrays), pctx.row_rank, n,
                       cfg.max_images * cfg.num_image_tokens)
    heads, caches, calls = set(), [], []
    orig = (decoder.flash_decode, decoder.init_cache)

    def decode(q, k, *a, **kw):
        heads.add((int(q.shape[1]), int(k.shape[1])))
        calls.append(1)
        return orig[0](q, k, *a, **kw)

    def init_cache(*a, **kw):
        cache = orig[1](*a, **kw)
        caches.append((int(cache.k.shape[0]), cache.first_layer))
        return cache

    decoder.flash_decode, decoder.init_cache = decode, init_cache
    gen = torch.Generator().manual_seed(100 + rank)
    try:
        with active(pctx):
            if how == "stream":
                ids = np.concatenate(list(tgen.generate_stream(
                    model, batch, _gcfg(**gkw), chunk=2)), axis=1)
            else:
                ids = tgen.generate(model, batch, _gcfg(**gkw), gen)
    finally:
        decoder.flash_decode, decoder.init_cache = orig
    np.savez(os.path.join(root, f"{name}_rank{rank}.npz"), ids=ids,
             row_rank=pctx.row_rank, heads=np.array(sorted(heads)),
             caches=np.array(caches), decode_calls=len(calls),
             pipe_rank=pctx.pipe_rank)


def _world(rank, world, store, root, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for name, args in cases.items():
            _case(rank, root, name, *args)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen"))
    cfg = tiny_llava_config(moe_layers=(0, 1))
    jcfg, params, model = matched_llava(cfg, seed=7)
    builder.save_model(os.path.join(root, "model"), model)
    cfg4 = tiny_llava_config(num_layers=4, moe_layers=(1, 3))
    jcfg4, params4, model4 = matched_llava(cfg4, seed=9)
    builder.save_model(os.path.join(root, "model4"), model4)
    arrays = multimodal_arrays(cfg, LENGTHS, T, seed=8,
                               with_image=WITH_IMAGE)
    np.savez(os.path.join(root, "batch.npz"), **arrays)
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, {**CASES2, **CASES_PP2}), (8, CASES8),
                          (4, CASES_PP4))]
    torch.set_num_threads(1)
    single, want = {}, {}
    for tag, m, jc, p in (("", model, jcfg, params),
                          ("4", model4, jcfg4, params4)):
        for k, kw in (("float32", {}), ("int8", dict(cache_dtype="int8"))):
            single[k + tag] = tgen.generate(m, torch_batch(arrays),
                                            _gcfg(**kw))
        want[tag] = _jax_generate(p, jc, arrays)
    for p in procs:
        while not p.join():
            pass
    return root, single, want, cfg


def _jax_generate(params, jcfg, arrays):
    """JAX's unsharded greedy `generate`, decoding through its XLA
    branch."""
    old = os.environ.get("LLAVAMOD_DECODE_ATTN")
    os.environ["LLAVAMOD_DECODE_ATTN"] = "xla"
    try:
        return np.asarray(jgen.generate(
            params, jcfg, jax_batch(arrays),
            jgen.GenerationConfig(max_new_tokens=NEW, cache_dtype="float32"),
            rng=jax.random.PRNGKey(0)))
    finally:
        if old is None:
            os.environ.pop("LLAVAMOD_DECODE_ATTN")
        else:
            os.environ["LLAVAMOD_DECODE_ATTN"] = old


def _ranks(root, name, world):
    return [dict(np.load(os.path.join(root, f"{name}_rank{r}.npz")))
            for r in range(world)]


def _world_ids(ranks):
    """The rows of every row rank, in row order (each row rank's from its
    first rank)."""
    by_row = {}
    for r in ranks:
        by_row.setdefault(int(r["row_rank"]), r["ids"])
    return np.concatenate([by_row[i] for i in sorted(by_row)])


@pytest.mark.parametrize("name", ["tp", "tp_sp", "fsdp2_expert2_tp2",
                                  "tp_stream", "pp2", "pp2_tp2",
                                  "pp2_stream"])
def test_greedy_generation_under_a_mesh_matches_single_process_and_jax(
        runs, name):
    root, single, want, cfg = runs
    tag = "4" if name.startswith("pp") else ""
    ranks = _ranks(root, name, WORLDS[name])
    got = _world_ids(ranks)
    assert got.shape == (len(LENGTHS), NEW)
    np.testing.assert_array_equal(got, single["float32" + tag])
    np.testing.assert_array_equal(got, want[tag])
    # every rank of a tensor group emits its rows' tokens
    n = len(ranks[0]["ids"])
    for r in ranks:
        i = int(r["row_rank"])
        np.testing.assert_array_equal(r["ids"], got[i * n:(i + 1) * n])


def test_int8_cache_under_a_tensor_split_matches_single_process(runs):
    root, single, _, _ = runs
    got = _world_ids(_ranks(root, "tp_int8", 2))
    np.testing.assert_array_equal(got, single["int8"])


def test_int8_cache_under_the_pipeline_matches_single_process(runs):
    root, single, _, _ = runs
    got = _world_ids(_ranks(root, "pp2_int8", 2))
    np.testing.assert_array_equal(got, single["int84"])


def test_sampled_tokens_agree_over_the_tensor_group(runs):
    """Temperature 1, the ranks' generators seeded apart: tensor rank 0's
    draw is broadcast, so both ranks emit the same (valid) ids."""
    root, _, _, cfg = runs
    a, b = _ranks(root, "tp_sample", 2)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    assert ((a["ids"] >= 0) & (a["ids"] < cfg.llm.vocab_size)).all()


def test_sampled_tokens_agree_over_the_pipe_group(runs):
    """The same at pipe=2: pipe rank 0's draw is broadcast to stage 1."""
    root, _, _, cfg = runs
    a, b = _ranks(root, "pp2_sample", 2)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    assert ((a["ids"] >= 0) & (a["ids"] < cfg.llm.vocab_size)).all()


@pytest.mark.parametrize("name", ["tp", "fsdp2_expert2_tp2"])
def test_decode_attention_runs_on_the_local_kv_heads(runs, name):
    root, _, _, cfg = runs
    for r in _ranks(root, name, WORLDS[name]):
        assert r["heads"].tolist() == [[cfg.llm.num_heads // 2,
                                        cfg.llm.num_kv_heads // 2]]


@pytest.mark.parametrize("name", ["pp2", "pp2_tp2", "pp2_int8"])
def test_each_stage_caches_and_decodes_its_own_layers(runs, name):
    """Each rank's cache holds its stage's 2 of the 4 layers (slot 0 is
    layer 2 * stage), and K2 runs on them once a layer and decode step,
    with the rank's KV heads."""
    root, _, _, cfg = runs
    tp = 2 if name == "pp2_tp2" else 1
    for r in _ranks(root, name, WORLDS[name]):
        stage = int(r["pipe_rank"])
        assert r["caches"].tolist() == [[2, 2 * stage]]
        assert int(r["decode_calls"]) == 2 * (NEW - 1)
        assert r["heads"].tolist() == [[cfg.llm.num_heads // tp,
                                        cfg.llm.num_kv_heads // tp]]
