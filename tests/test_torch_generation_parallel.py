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
    attention sees them."""

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


def _gcfg(**kw):
    base = dict(max_new_tokens=NEW, cache_dtype="float32")
    base.update(kw)
    return tgen.GenerationConfig(**base)


def _case(rank, root, name, mesh_kw, gkw, seq, how):
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.parallel.collectives import (
        ParallelContext,
        active,
    )
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from llavamod_tpu_torch.parallel.sharding import shard_params
    from llavamod_tpu_torch.train.steps import _row_chunk

    cfg, model = builder.load_model(os.path.join(root, "model"),
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
    heads = set()
    orig = decoder.flash_decode

    def decode(q, k, *a, **kw):
        heads.add((int(q.shape[1]), int(k.shape[1])))
        return orig(q, k, *a, **kw)

    decoder.flash_decode = decode
    gen = torch.Generator().manual_seed(100 + rank)
    try:
        with active(pctx):
            if how == "stream":
                ids = np.concatenate(list(tgen.generate_stream(
                    model, batch, _gcfg(**gkw), chunk=2)), axis=1)
            else:
                ids = tgen.generate(model, batch, _gcfg(**gkw), gen)
    finally:
        decoder.flash_decode = orig
    np.savez(os.path.join(root, f"{name}_rank{rank}.npz"), ids=ids,
             row_rank=pctx.row_rank, heads=np.array(sorted(heads)))


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
    arrays = multimodal_arrays(cfg, LENGTHS, T, seed=8,
                               with_image=WITH_IMAGE)
    np.savez(os.path.join(root, "batch.npz"), **arrays)
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, CASES2), (8, CASES8))]
    torch.set_num_threads(1)
    single = {k: tgen.generate(model, torch_batch(arrays), _gcfg(**kw))
              for k, kw in (("float32", {}),
                            ("int8", dict(cache_dtype="int8")))}
    old = os.environ.get("LLAVAMOD_DECODE_ATTN")
    os.environ["LLAVAMOD_DECODE_ATTN"] = "xla"
    try:
        want = jgen.generate(params, jcfg, jax_batch(arrays),
                             jgen.GenerationConfig(max_new_tokens=NEW,
                                                   cache_dtype="float32"),
                             rng=jax.random.PRNGKey(0))
    finally:
        if old is None:
            os.environ.pop("LLAVAMOD_DECODE_ATTN")
        else:
            os.environ["LLAVAMOD_DECODE_ATTN"] = old
    for p in procs:
        while not p.join():
            pass
    return root, single, np.asarray(want), cfg


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
                                  "tp_stream"])
def test_greedy_generation_under_a_mesh_matches_single_process_and_jax(
        runs, name):
    root, single, want, cfg = runs
    world = 8 if name in CASES8 else 2
    ranks = _ranks(root, name, world)
    got = _world_ids(ranks)
    assert got.shape == (len(LENGTHS), NEW)
    np.testing.assert_array_equal(got, single["float32"])
    np.testing.assert_array_equal(got, want)
    # every rank of a tensor group emits its rows' tokens
    n = len(ranks[0]["ids"])
    for r in ranks:
        i = int(r["row_rank"])
        np.testing.assert_array_equal(r["ids"], got[i * n:(i + 1) * n])


def test_int8_cache_under_a_tensor_split_matches_single_process(runs):
    root, single, _, _ = runs
    got = _world_ids(_ranks(root, "tp_int8", 2))
    np.testing.assert_array_equal(got, single["int8"])


def test_sampled_tokens_agree_over_the_tensor_group(runs):
    """Temperature 1, the ranks' generators seeded apart: tensor rank 0's
    draw is broadcast, so both ranks emit the same (valid) ids."""
    root, _, _, cfg = runs
    a, b = _ranks(root, "tp_sample", 2)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    assert ((a["ids"] >= 0) & (a["ids"] < cfg.llm.vocab_size)).all()


@pytest.mark.parametrize("name", ["tp", "fsdp2_expert2_tp2"])
def test_decode_attention_runs_on_the_local_kv_heads(runs, name):
    root, _, _, cfg = runs
    world = 8 if name in CASES8 else 2
    for r in _ranks(root, name, world):
        assert r["heads"].tolist() == [[cfg.llm.num_heads // 2,
                                        cfg.llm.num_kv_heads // 2]]
