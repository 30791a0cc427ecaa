"""The port's mesh and sharding rules (llavamod_tpu_torch/parallel/
{mesh,sharding}.py) against the JAX package's (llavamod_tpu/parallel/):

  * `param_specs` gives every parameter the JAX rule, path for path, over
    the tiny MoE LLaVA-MoD and over the full LLaVA-MoD-2B tree (the JAX
    side from `jax.eval_shape` of `llava.init`, the port's from a model on
    the meta device: no weights are allocated on either side);
  * `fit_spec_to_shape` replicates the dims a mesh does not divide, as
    JAX's does (tests/test_parallel.py's cases and more), and `fsdp_dim`
    picks the dim FSDP2 splits from it;
  * `batch_spec`, `MeshConfig.size` and `MeshConfig.auto` as JAX's;
  * `make_mesh` refuses pipeline parallelism with the ROADMAP item that
    ports it (14) before it touches a process group, and builds a tensor=2
    mesh whose context holds the right groups (2 ranks under gloo);
  * the rows a rank's experts compute follow what the rank received, not
    the world's capacity: under a context of W ranks that mirror this
    process's rows, the expert batch keeps its size as W grows."""

import dataclasses

import jax
import pytest
import torch

from util_torch_port import tiny_llava_config, to_jax_llava

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.parallel import mesh as jmesh
from llavamod_tpu.parallel import sharding as jsharding
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.llava import LlavaConfig
from llavamod_tpu_torch.models.llm.config import (
    QWEN1_5_1_8B,
    moe_layer_indices,
)
from llavamod_tpu_torch.models.vision.vit import CLIP_VIT_L_336
from llavamod_tpu_torch.parallel import MeshConfig, make_mesh
from llavamod_tpu_torch.parallel.sharding import (
    P,
    batch_spec,
    fit_spec_to_shape,
    fsdp_dim,
    param_specs,
)


def _full_llavamod_2b() -> LlavaConfig:
    """The smoke's student: Qwen1.5-1.8B upcycled to 4 experts top-2 on
    the even layers, CLIP-ViT-L/336, mlp2x_gelu."""
    llm = QWEN1_5_1_8B.replace(
        moe_num_experts=4, moe_top_k=2,
        moe_layers=moe_layer_indices("sparse", QWEN1_5_1_8B.num_layers))
    return LlavaConfig(llm=llm, vision=CLIP_VIT_L_336,
                       projector_type="mlp2x_gelu")


def _jax_specs(cfg: LlavaConfig) -> dict:
    shapes = jax.eval_shape(
        lambda: jllava.init(to_jax_llava(cfg), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {jsharding._path_str(path).replace("/", "."):
            tuple(jsharding._spec_for(jsharding._path_str(path), leaf.ndim))
            for path, leaf in flat}


def _port_specs(cfg: LlavaConfig) -> dict:
    model = tllava.init(cfg, None, device="meta")
    return {k: tuple(v) for k, v in param_specs(model).items()}


@pytest.mark.parametrize("which", ["tiny", "llavamod_2b"])
def test_param_specs_equal_jax_path_for_path(which):
    cfg = (tiny_llava_config(moe_num_experts=4, moe_layers=(0, 1))
           if which == "tiny" else _full_llavamod_2b())
    want, got = _jax_specs(cfg), _port_specs(cfg)
    assert got.keys() == want.keys()
    assert got == want
    experts = [k for k in got if ".experts." in k]
    assert experts and all(got[k][0] == "expert" for k in experts)
    if which == "llavamod_2b":
        assert got["llm.embed.embedding"] == (("tensor", "fsdp"), None)
        assert got["llm.layers.0.mlp.experts.down"] == ("expert", "tensor",
                                                        "fsdp")
        assert len(got) == len(want) == 699


@pytest.mark.parametrize("spec,shape,want", [
    (P("fsdp", None), (9, 4), P(None, None)),
    (P("fsdp", None), (16, 4), P("fsdp", None)),
    (P(("tensor", "fsdp"), None), (24, 4), P(("tensor", "fsdp"), None)),
    (P("expert", "fsdp", "tensor"), (4, 16, 6), P("expert", "fsdp",
                                                  "tensor")),
    (P("expert", "fsdp", "tensor"), (4, 12, 6), P("expert", None, "tensor")),
    (P("tensor", "fsdp"), (6, 10), P("tensor", None)),
], ids=["indivisible", "divisible", "vocab", "experts", "experts-odd-d",
        "out-proj-odd"])
def test_fit_spec_to_shape_matches_jax(spec, shape, want):
    """tests/test_parallel.py's cases (fsdp=8) and the rule shapes FSDP2
    meets, against JAX's `fit_spec_to_shape` on the 8 virtual devices."""
    axes = dict(data=1, fsdp=8, expert=1, tensor=1)
    got = fit_spec_to_shape(MeshConfig(**axes), spec, shape)
    assert got == want
    jgot = jsharding.fit_spec_to_shape(jmesh.make_mesh(jmesh.MeshConfig(
        **axes)), jax.sharding.PartitionSpec(*spec), shape)
    assert tuple(jgot) == tuple(got)


def test_fsdp_dim_follows_the_rule_else_dim_0():
    sizes = dict(pipe=1, data=1, fsdp=2, expert=2, tensor=1)
    assert fsdp_dim(sizes, P("expert", "fsdp", "tensor"), (4, 64, 128)) == 1
    assert fsdp_dim(sizes, P("expert", "tensor", "fsdp"), (4, 128, 64)) == 2
    assert fsdp_dim(sizes, P("tensor", "fsdp"), (64, 64)) == 1     # wo
    assert fsdp_dim(sizes, P(("tensor", "fsdp"), None), (512, 64)) == 0
    assert fsdp_dim(sizes, P(None), (64,)) == 0                    # a norm
    assert fsdp_dim(sizes, P("tensor", "fsdp"), (64, 63)) == 0     # dropped


@pytest.mark.parametrize("ndim", [0, 1, 2, 3])
@pytest.mark.parametrize("seq", [False, True])
def test_batch_spec_matches_jax(ndim, seq):
    assert tuple(batch_spec(ndim, seq_sharded=seq)) == tuple(
        jsharding.batch_spec(ndim, seq_sharded=seq))


def test_mesh_config_size_and_auto_match_jax():
    for kw in (dict(data=2, fsdp=2, expert=2), dict(fsdp=4, tensor=2),
               dict(pipe=2, data=3)):
        assert MeshConfig(**kw).size == jmesh.MeshConfig(**kw).size
    for n, kw in ((8, dict(expert=2)), (4, {}), (8, dict(expert=2,
                                                         tensor=2))):
        assert dataclasses.asdict(MeshConfig.auto(n, **kw)) == \
            dataclasses.asdict(jmesh.MeshConfig.auto(n, **kw))
    assert MeshConfig.auto() == MeshConfig()     # one process: fsdp=1


def _tensor_mesh_groups(rank, world, store, out, axes):
    """One rank of a tensor=2 or pipe=2 mesh: its context's groups as rank
    lists."""
    import json

    import torch.distributed as dist

    from llavamod_tpu_torch.parallel.collectives import ParallelContext

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        ctx = ParallelContext(make_mesh(MeshConfig(**axes), "cpu"))
        got = dict(
            tensor=dist.get_process_group_ranks(ctx.tensor_group),
            rows=dist.get_process_group_ranks(ctx.rows_group),
            fsdp=dist.get_process_group_ranks(ctx.fsdp_group),
            expert=dist.get_process_group_ranks(ctx.expert_group),
            pipe=dist.get_process_group_ranks(ctx.pipe_group),
            param_mesh=ctx.param_mesh.mesh.tolist(),
            sizes=[ctx.tensor_size, ctx.tensor_rank, ctx.rows, ctx.row_rank,
                   ctx.pipe_size, ctx.pipe_rank, ctx.stage_rank])
        with open(f"{out}{rank}.json", "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("axes,item", [(dict(tensor=2), 13),
                                       (dict(pipe=2), 14)])
def test_make_mesh_refuses_tensor_and_pipeline(axes, item, tmp_path):
    """Tensor parallelism (item 13) and pipeline parallelism (item 14) are
    ported: a tensor=2 mesh over 2 ranks gives each rank both in its tensor
    group, itself alone in its rows, fsdp, expert and pipe groups and in
    its FSDP2 mesh; a pipe=2 mesh gives each rank both in its pipe group
    (stage = rank), itself alone in every other group and one row rank of
    its own (the stages hold the same rows)."""
    import json

    import torch.multiprocessing as mp

    assert not torch.distributed.is_initialized()
    out = str(tmp_path / "groups")
    mp.spawn(_tensor_mesh_groups, args=(2, str(tmp_path / "store"), out,
                                        axes), nprocs=2)
    for rank in range(2):
        with open(f"{out}{rank}.json") as f:
            got = json.load(f)
        if item == 13:
            assert got == dict(tensor=[0, 1], rows=[rank], fsdp=[rank],
                               expert=[rank], pipe=[rank],
                               param_mesh=[[rank]],
                               sizes=[2, rank, 1, 0, 1, 0, rank])
        else:
            assert got == dict(tensor=[rank], rows=[rank], fsdp=[rank],
                               expert=[rank], pipe=[0, 1],
                               param_mesh=[[rank]],
                               sizes=[1, 0, 1, 0, 2, rank, 0])
    assert not torch.distributed.is_initialized()


def test_a_dtensor_reaching_a_kernel_wrapper_raises(tmp_path):
    """Under FSDP2 the kernels see plain tensors; a DTensor that reaches a
    wrapper raises instead of being converted (on the CPU too)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from llavamod_tpu_torch.ops.decode_attention import flash_decode
    from llavamod_tpu_torch.ops.flash_attention import flash_dq, flash_fwd

    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(str(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        q = torch.randn(1, 8, 2, 64)
        dq = distribute_tensor(q, mesh, [Replicate()])
        flash_fwd(q, q, q)                         # plain tensors run
        with pytest.raises(TypeError, match="DTensor"):
            flash_fwd(dq, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            flash_dq(q, q, dq, q, None, None)
        with pytest.raises(TypeError, match="DTensor"):
            flash_decode(dq[:, 0], q, q, kv_seg=torch.ones(1, 8))
    finally:
        torch.distributed.destroy_process_group()


class _Mirrors:
    """A parallel context of `world` ranks that all hold this process's
    rows, with an expert group of one.  This process is rank 0, so its
    tokens come first in the world's order and keep their single-process
    slots; only the gate's capacity grows with the world."""

    def __init__(self, world):
        self.world, self.rank, self.segments, self.expert_size = (
            world, 0, 1, 1)
        self.rows, self.tensor_size = world, 1

    def gather_rows(self, x):
        return torch.cat([x] * self.world), torch.arange(x.shape[0])

    def gather_values(self, x):
        return torch.cat([x] * self.world)

    def exchange_counts(self, counts):
        return counts, (counts.tolist(), counts.tolist())

    def exchange(self, x, send, recv):
        return x

    def exchange_back(self, y, send, recv):
        return y


@pytest.mark.parametrize("dispatch", ["gather", "einsum", "ragged"])
def test_expert_rows_do_not_grow_with_the_world(dispatch, monkeypatch):
    """The expert batch a rank computes holds its received rows padded to
    its fullest local expert: the same at world 1, 2 and 8 (nothing is
    dropped at capacity factor 2.0), below the world's capacity, and the
    block's output does not move."""
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.ops.moe import GatingConfig
    from llavamod_tpu_torch.parallel.collectives import active

    cfg = tiny_llava_config(moe_capacity_factor=2.0, moe_dispatch=dispatch)
    llm = cfg.llm
    model = tllava.init(cfg, torch.Generator().manual_seed(0))
    block = model.llm.layers[0].mlp
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        block.router.copy_(torch.randn(block.router.shape, generator=g))
    x = torch.randn(2, 24, llm.hidden_size, generator=g)
    rows = []
    dense, ragged = decoder._expert_mlp, decoder._expert_mlp_ragged
    monkeypatch.setattr(decoder, "_expert_mlp", lambda c, p, xe: (
        rows.append(xe.shape[0] * xe.shape[1]), dense(c, p, xe))[1])
    monkeypatch.setattr(decoder, "_expert_mlp_ragged", lambda c, p, xr, sz: (
        rows.append(xr.shape[0]), ragged(c, p, xr, sz))[1])
    outs = []
    for world in (1, 2, 8):
        with active(_Mirrors(world)), torch.no_grad():
            outs.append(decoder.moe_block_forward(llm, block, x, True,
                                                  None)[0])
    assert len(rows) == 3 and rows[0] == rows[1] == rows[2], rows
    gcfg = GatingConfig(num_experts=4, top_k=2, capacity_factor=2.0,
                        min_capacity=llm.moe_min_capacity)
    assert rows[2] < 4 * gcfg.capacity(8 * 48, True)
    if dispatch == "ragged":                 # exactly the kept choices
        assert rows[0] == 2 * 48
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
