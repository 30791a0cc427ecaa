"""The process-sharded data path of the port (llavamod_tpu_torch/train/
sampler.py `ProcessShardSampler`, one process per card, each rank's loader
yielding its own rows) against the JAX package's:

  * the port's ProcessShardSampler yields JAX's indices on the cases of
    tests/test_multihost_data.py (a random order in 4 shards, epoch
    reseeding, the length-grouped sampler in 2 shards);
  * the JAX package's multi-process batch assembly splices process 0's
    image features into process 1's rows: its collator writes `image_pos`
    as rows of its own batch's media table, and `shard_batch(multihost=
    True)` stacks the processes' batches without re-offsetting them
    (llavamod_tpu/parallel/sharding.py:146-169, llavamod_tpu/data/
    collator.py:25-28), so the single-device `llava.forward` on the
    assembled batch gives process 1's row the hidden states of its tokens
    around process 0's image.  The port's 2-rank forward (gloo, FSDP2)
    gives each row its own image: the single-process forward of the
    correctly offset global batch."""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from util_torch_port import matched_llava, tiny_llava_config

from llavamod_tpu.data.collator import SupervisedCollator as JCollator
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.train import sampler as jsampler
from llavamod_tpu.train.steps import batch_from_arrays as jbatch_from_arrays
from llavamod_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llavamod_tpu_torch.data.collator import SupervisedCollator
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.train import sampler as tsampler
from llavamod_tpu_torch.train.steps import batch_from_arrays

T = 24


def _samplers(make, n):
    return ([list(iter(tsampler.ProcessShardSampler(make(tsampler), r, n)))
             for r in range(n)],
            [list(iter(jsampler.ProcessShardSampler(make(jsampler), r, n)))
             for r in range(n)])


@pytest.mark.parametrize("case", ["random", "epoch", "length_grouped"])
def test_process_shard_sampler_yields_the_indices_of_jax(case):
    if case == "random":
        got, want = _samplers(lambda m: m.RandomSampler(103, seed=7), 4)
        assert all(len(g) == 103 // 4 for g in got)
        order = list(iter(tsampler.RandomSampler(103, seed=7)))
        assert got == [order[r::4][:25] for r in range(4)]
    elif case == "epoch":
        def make(m):
            s = m.RandomSampler(64, seed=3)
            s.set_epoch(5)
            return s
        got, want = _samplers(make, 2)
        assert not set(got[0]) & set(got[1])
        fresh = tsampler.ProcessShardSampler(tsampler.RandomSampler(
            64, seed=3), 0, 2)
        fresh.set_epoch(5)
        assert list(iter(fresh)) == got[0]
    else:
        lengths = [int(x) for x in
                   np.random.default_rng(0).integers(1, 500, size=120)]
        got, want = _samplers(lambda m: m.LengthGroupedSampler(
            4, world_size=2, lengths=lengths, seed=1), 2)
        assert sorted(got[0] + got[1]) == list(range(120))
    assert got == want


def _samples(cfg, rng):
    """Two samples, one per process: an image after two text tokens, the
    answer supervised."""
    s = cfg.vision.image_size
    out = []
    for i in range(2):
        ids = [int(x) for x in rng.randint(5, 500, 8)]
        ids = ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:]
        out.append({"input_ids": ids, "labels": [-100] * 5 + ids[5:],
                    "pixels": rng.randn(1, 3, s, s).astype(np.float32)
                    * (1 + 3 * i)})
    return out


def _collate(cls, cfg, samples):
    return cls(max_len=T, num_image_tokens=cfg.num_image_tokens,
               image_size=cfg.vision.image_size)(samples)


def _hidden_jax(jcfg, params, arrays):
    return np.asarray(jllava.forward(params, jcfg, jbatch_from_arrays(arrays),
                                     attn_impl="xla").hidden)


def _rank_forward(rank, world, store, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from llavamod_tpu_torch.parallel import MeshConfig, make_mesh
        from llavamod_tpu_torch.parallel.collectives import (
            ParallelContext,
            active,
        )
        from llavamod_tpu_torch.parallel.sharding import shard_params

        _, model = builder.load_model(os.path.join(root, "model"),
                                      device="cpu")
        mesh = make_mesh(MeshConfig(fsdp=world), "cpu")
        pctx = ParallelContext(mesh)
        shard_params(mesh, model, torch.float32, ctx=pctx)
        arrays = dict(np.load(os.path.join(root, f"rank{rank}.npz")))
        with torch.no_grad(), active(pctx):
            h = model(batch_from_arrays(arrays, device="cpu"),
                      attn_impl="xla").hidden
        parts = [torch.empty_like(h) for _ in range(world)]
        dist.all_gather(parts, h.contiguous())
        if rank == 0:
            np.save(os.path.join(root, "hidden.npy"),
                    torch.cat(parts).numpy())
    finally:
        dist.destroy_process_group()


def test_multi_process_image_pos_jax_splices_rank_0_port_does_not(tmp_path):
    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    jcfg, params, model = matched_llava(cfg, seed=0)
    samples = _samples(cfg, np.random.RandomState(0))
    n_img = cfg.num_image_tokens

    # 1-2: each process's batch through the JAX collator, stacked as
    # shard_batch(multihost=True) assembles them: image_pos left as it is
    ranks = [_collate(JCollator, cfg, [s]) for s in samples]
    stacked = {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]}
    assert np.array_equal(stacked["image_pos"][1], ranks[1]["image_pos"][0])
    correct = _collate(JCollator, cfg, samples)      # one batch of both rows
    img = correct["image_mask"][1]
    assert img.sum() == n_img and np.array_equal(
        correct["image_pos"][1][img], n_img + np.arange(n_img))
    assert np.array_equal(stacked["image_pos"][1][img], np.arange(n_img))

    # 3: JAX's single-device forward on the assembled batch: row 1 holds
    # process 0's image (equal to row 1 with process 0's pixels, correctly
    # offset), not its own
    h_fault = _hidden_jax(jcfg, params, stacked)
    h_ok = _hidden_jax(jcfg, params, correct)
    swapped = dict(correct, pixels=correct["pixels"][[0, 0]])
    h_swap = _hidden_jax(jcfg, params, swapped)
    np.testing.assert_allclose(h_fault[1], h_swap[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_fault[0], h_ok[0], rtol=1e-5, atol=1e-6)
    assert np.abs(h_fault[1] - h_ok[1]).max() > 1e-2

    # 4: the port's 2-rank forward, each rank on its own collator batch
    root = str(tmp_path)
    builder.save_model(os.path.join(root, "model"), model)
    for r, s in enumerate(samples):
        np.savez(os.path.join(root, f"rank{r}.npz"),
                 **_collate(SupervisedCollator, cfg, [s]))
    mp.spawn(_rank_forward, args=(2, tempfile.mktemp(dir=root), root),
             nprocs=2)
    got = np.load(os.path.join(root, "hidden.npy"))
    with torch.no_grad():
        single = model(batch_from_arrays(
            _collate(SupervisedCollator, cfg, samples), device="cpu"),
            attn_impl="xla").hidden.numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, h_ok, rtol=1e-4, atol=1e-5)
    assert np.abs(got[1] - h_fault[1]).max() > 1e-2
