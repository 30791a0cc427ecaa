"""The process groups of a mesh and the collectives the training step runs
on them.

`ParallelContext(mesh)` holds, for one rank of a `make_mesh` mesh:

  * `param_mesh` — 2-D (data x expert, fsdp) of the rank's pipe and tensor
    index: FSDP2 shards every parameter but the experts over fsdp and
    replicates it over data and expert (HSDP);
  * `expert_param_mesh` — 2-D (data, fsdp) of the rank's own expert slot
    and pipe and tensor index: the experts a rank keeps (E / expert of
    them) are sharded over fsdp and replicated over data;
  * the `expert`, `fsdp`, `tensor` and `pipe` groups, and the rows group:
    the ranks of data x fsdp x expert at the rank's pipe and tensor index,
    which own distinct rows (the ranks along `tensor` and along `pipe`
    hold the same rows);
  * the pipeline's transport between the stages (`send_stage`,
    `recv_stage`, `broadcast_stage`): NCCL's point-to-point on the card's
    memory, or under gloo, which reads and writes host memory only, through
    a host buffer.  The stages' order of transfers is the schedule's
    (parallel/pipeline.py), never autograd's.

While a context is `active`, the MoE block gates the rows group's tokens as
one set (`gather_rows`) and sends each kept token to the rank that owns its
expert (`exchange`), and the losses divide by the rows group's token counts
(`all_sum`).  Outside one, every function of the model runs as in a single
process.  The gradient of each collective is its transpose: the gather's
is the sum over ranks of the gathered rows' cotangents, the exchange's the
inverse exchange.

Tensor parallelism (Megatron-LM's column / row splits) runs on the `tensor`
group with these pairs, each the other's transpose:

  * `column_in` / `row_out` around a column-parallel product and the
    row-parallel one after it: copy-in and all-reduce (Megatron's f and g),
    or under sequence parallelism the all-gather over T and the
    reduce-scatter over T;
  * `split_seq` / `gather_copies`: a replicated [B, T, ...] tensor cut to
    the rank's T-shard (its gradient gathers the shards), and the shards
    of a tensor every rank then uses whole (its gradient takes the rank's
    shard of the cotangent, identical on every rank);
  * `tensor_max`, `tensor_sum` (no gradient): the vocab-parallel loss's
    statistics and the int8 products' row scales and int32 partial sums.

Every rank of a tensor group holds the same loss; a tensor that is the same
on every rank of the group holds its whole cotangent on every rank, and a
rank's partial sum (the output of a row-parallel product before its
reduction) takes the cotangent of the sum.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from llavamod_tpu_torch.parallel.mesh import mesh_config, rank_grid

_ACTIVE: List["ParallelContext"] = []

# the pipeline's point-to-point traffic since the last `reset_transport`:
# transfers, bytes sent and the host time spent in them
transport: Dict[str, float] = dict(sends=0, recvs=0, broadcasts=0, bytes=0,
                                   host_ms=0.0)


def reset_transport() -> None:
    transport.update(sends=0, recvs=0, broadcasts=0, bytes=0, host_ms=0.0)


def current() -> Optional["ParallelContext"]:
    """The active context, or None (a single process)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def active(ctx: Optional["ParallelContext"]):
    """Within the block the model's collectives run on `ctx` (no-op for
    None)."""
    if ctx is None:
        yield None
        return
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


class _GatherRows(torch.autograd.Function):
    """All ranks' rows, rank-major; the cotangent of a rank's rows is the
    sum over ranks of theirs."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        rows = slice(ctx.rank * ctx.rows, (ctx.rank + 1) * ctx.rows)
        return g[rows], None, None, None


class _Exchange(torch.autograd.Function):
    """all_to_all_single with uneven splits; its backward is the inverse
    exchange."""

    @staticmethod
    def forward(ctx, x, send: List[int], recv: List[int], group):
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((sum(ctx.send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(out, g.contiguous(), ctx.send, ctx.recv,
                               group=ctx.group)
        return out, None, None, None


def _gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((size * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                        size: int) -> torch.Tensor:
    """The sum over the group, this rank's slice of `dim`."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // size,) + tuple(x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


class _CopyIn(torch.autograd.Function):
    """Identity; the backward all-reduces (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """All-reduce; the backward is the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along `dim`; the backward reduce-scatters (the ranks'
    cotangents are partial: column-parallel products follow)."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = (dim, group, size)
        return _gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, *ctx.args), None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter along `dim`; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = (dim, group, size)
        return _reduce_scatter_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, *ctx.args), None, None, None


class _SplitSeq(torch.autograd.Function):
    """The rank's slice of `dim` of a tensor that is the same on every
    rank; the backward all-gathers the slices' cotangents."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, group, size)
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_dim(g, *ctx.args), None, None, None, None)


class _GatherCopies(torch.autograd.Function):
    """All-gather along `dim` for a use that every rank repeats whole (the
    MoE gate): the backward keeps the rank's slice of the cotangent, which
    is the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, size, rank)
        return _gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, size, rank = ctx.args
        return (g.chunk(size, dim=dim)[rank].contiguous(), None, None, None,
                None)


def tensor_size(pctx: Optional["ParallelContext"]) -> int:
    """The tensor-parallel degree under `pctx` (1 without one)."""
    return 1 if pctx is None else pctx.tensor_size


def column_in(x: torch.Tensor, pctx, seq: bool, dim: int = 1
              ) -> torch.Tensor:
    """The input of a column-parallel product: `x` itself (copy-in, its
    gradient all-reduced over tensor), or with sequence parallelism the
    T-shards gathered along `dim` (the gradient reduce-scattered)."""
    if seq and tensor_size(pctx) > 1:
        return _GatherSeq.apply(x, dim, pctx.tensor_group, pctx.tensor_size)
    return copy_in(x, pctx)


def row_out(x: torch.Tensor, pctx, seq: bool, dim: int = 1) -> torch.Tensor:
    """The output of a row-parallel product, the ranks' partial sums: their
    all-reduce, or with sequence parallelism its reduce-scatter along
    `dim` (the rank's T-shard)."""
    if seq and tensor_size(pctx) > 1:
        return _ReduceScatterSeq.apply(x, dim, pctx.tensor_group,
                                       pctx.tensor_size)
    return reduce_out(x, pctx)


def split_seq(x: torch.Tensor, pctx, dim: int = 1) -> torch.Tensor:
    """The rank's T-shard of a tensor that is the same on every tensor
    rank (the residual stream entering sequence parallelism)."""
    if tensor_size(pctx) == 1:
        return x
    if x.shape[dim] % pctx.tensor_size:
        raise ValueError(f"sequence parallelism needs T % tensor == 0; "
                         f"T={x.shape[dim]}, tensor={pctx.tensor_size}")
    return _SplitSeq.apply(x, dim, pctx.tensor_group, pctx.tensor_size,
                           pctx.tensor_rank)


def gather_copies(x: torch.Tensor, pctx, dim: int = 1) -> torch.Tensor:
    """The T-shards gathered along `dim` for a computation that every
    tensor rank repeats whole (see `_GatherCopies`)."""
    if tensor_size(pctx) == 1:
        return x
    return _GatherCopies.apply(x, dim, pctx.tensor_group, pctx.tensor_size,
                               pctx.tensor_rank)


def copy_in(x: torch.Tensor, pctx) -> torch.Tensor:
    """Identity whose gradient is all-reduced over tensor: a tensor that is
    the same on every rank and weights each rank's partial sum."""
    if tensor_size(pctx) == 1:
        return x
    return _CopyIn.apply(x, pctx.tensor_group)


def reduce_out(x: torch.Tensor, pctx) -> torch.Tensor:
    """All-reduce over tensor of the ranks' partial sums (gradient: the
    identity)."""
    if tensor_size(pctx) == 1:
        return x
    return _ReduceOut.apply(x, pctx.tensor_group)


def tensor_sum(x: torch.Tensor, pctx,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Elementwise sum (or `op`) over the tensor group, no gradient: int32
    partial products, the vocab-parallel loss's sums."""
    if tensor_size(pctx) == 1:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=op, group=pctx.tensor_group)
    return y


def tensor_max(x: torch.Tensor, pctx) -> torch.Tensor:
    """Elementwise max over the tensor group (no gradient)."""
    return tensor_sum(x, pctx, dist.ReduceOp.MAX)


def tensor_reduce_scatter(x: torch.Tensor, pctx, dim: int) -> torch.Tensor:
    """Sum over the tensor group, the rank's slice of `dim` (no
    gradient)."""
    if tensor_size(pctx) == 1:
        return x
    return _reduce_scatter_dim(x.detach(), dim, pctx.tensor_group,
                               pctx.tensor_size)


def tensor_gather(x: torch.Tensor, pctx, dim: int) -> torch.Tensor:
    """The tensor group's slices concatenated along `dim` (no gradient)."""
    if tensor_size(pctx) == 1:
        return x
    return _gather_dim(x.detach(), dim, pctx.tensor_group, pctx.tensor_size)


class ParallelContext:
    def __init__(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh

        self.mesh = mesh
        self.cfg = cfg = mesh_config(mesh)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.device_type = mesh.device_type
        grid = rank_grid(cfg)                                # [P, D, F, X, T]
        p, d, f, x, t = grid.shape
        # every rank builds each mesh whole (its groups are made by all
        # ranks) and keeps the slice of its own pipe and tensor index
        self.param_mesh = DeviceMesh(
            self.device_type,
            grid.permute(0, 4, 1, 3, 2).reshape(p, t, d * x, f),
            mesh_dim_names=("pipe", "tensor", "data_expert", "fsdp"))[
                "data_expert", "fsdp"]
        self.expert_param_mesh = DeviceMesh(
            self.device_type, grid.permute(0, 4, 3, 1, 2),
            mesh_dim_names=("pipe", "tensor", "expert", "data", "fsdp"))[
                "data", "fsdp"]
        self.expert_group = mesh.get_group("expert")
        self.fsdp_group = mesh.get_group("fsdp")
        self.expert_size = cfg.expert
        self.expert_rank = mesh.get_local_rank("expert")
        self.fsdp_size = cfg.fsdp
        self.tensor_group = mesh.get_group("tensor")
        self.tensor_size = cfg.tensor
        self.tensor_rank = mesh.get_local_rank("tensor")
        # the pipeline's stages (parallel/pipeline.py): the ranks along pipe
        # hold the same rows and the same (data, fsdp, expert, tensor) index
        self.pipe_group = mesh.get_group("pipe")
        self.pipe_size = cfg.pipe
        self.pipe_rank = mesh.get_local_rank("pipe")
        self.pipe_ranks = dist.get_process_group_ranks(self.pipe_group)
        # the rank's place inside its stage: 0 for the stage's first rank
        self.stage_rank = self.rank % (self.world // cfg.pipe)
        # the ranks owning distinct rows: the world when tensor = pipe = 1
        self.rows = self.world // (cfg.tensor * cfg.pipe)
        self.row_rank = self.stage_rank // cfg.tensor
        self.rows_group = None if cfg.tensor == 1 and cfg.pipe == 1 else \
            DeviceMesh(self.device_type,
                       grid.permute(0, 4, 1, 2, 3).reshape(p, t, d * f * x),
                       mesh_dim_names=("pipe", "tensor", "rows")
                       ).get_group("rows")
        self.segments = 1

    # ---- the pipeline's transport ------------------------------------------

    def _staged(self) -> bool:
        """gloo's point-to-point reads and writes host memory only: a CUDA
        tensor goes through a host buffer (NCCL takes the device's)."""
        return dist.get_backend(self.pipe_group) == "gloo"

    def send_stage(self, x: torch.Tensor, stage: int) -> None:
        """Send `x` to the rank of pipe stage `stage` (blocking)."""
        t0 = time.perf_counter()
        x = x.detach().contiguous()
        if self._staged() and x.device.type != "cpu":
            x = x.cpu()
        elif not self._staged() and x.device.type == "cpu":
            x = x.to(self.device_type)
        dist.send(x, self.pipe_ranks[stage], group=self.pipe_group)
        transport["sends"] += 1
        transport["bytes"] += x.numel() * x.element_size()
        transport["host_ms"] += (time.perf_counter() - t0) * 1e3

    def recv_stage(self, shape, dtype, device, stage: int) -> torch.Tensor:
        """Receive a tensor of `shape` and `dtype` from the rank of pipe
        stage `stage` (blocking), on `device`."""
        t0 = time.perf_counter()
        where = "cpu" if self._staged() else self.device_type
        buf = torch.empty(shape, dtype=dtype, device=where)
        dist.recv(buf, self.pipe_ranks[stage], group=self.pipe_group)
        out = buf.to(device)
        transport["recvs"] += 1
        transport["host_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def broadcast_stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """`x` of pipe stage `stage` on every stage (in place)."""
        t0 = time.perf_counter()
        dist.broadcast(x, self.pipe_ranks[stage], group=self.pipe_group)
        transport["broadcasts"] += 1
        transport["host_ms"] += (time.perf_counter() - t0) * 1e3
        return x

    def pipe_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of `x` over the pipe group (no gradient)."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.pipe_group)
        return y

    # ---- the world's rows -------------------------------------------------

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of `x` over the rows group (no gradient): token counts."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.rows_group)
        return y

    @contextlib.contextmanager
    def token_segments(self, n: int):
        """Within the block each rank's tokens are `n` equal segments, and
        the world's token order is segment-major: the DPO step's [chosen;
        rejected] rows, which the single-process step concatenates over the
        whole batch."""
        old, self.segments = self.segments, n
        try:
            yield
        finally:
            self.segments = old

    def gather_rows(self, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the rows group's rows of x [S, ...] in the single-process
        order, the indices of this rank's rows in it).  Differentiable in
        x."""
        s, m, w = x.shape[0], self.segments, self.rows
        full = _GatherRows.apply(x, self.rows_group, w, self.row_rank)
        per = s // m
        if m > 1:
            full = full.reshape((w, m, per) + tuple(x.shape[1:])).transpose(
                0, 1).reshape((w * s,) + tuple(x.shape[1:]))
        idx = (torch.arange(m, device=x.device)[:, None] * (w * per)
               + self.row_rank * per
               + torch.arange(per, device=x.device)[None, :]).reshape(-1)
        return full, idx

    def gather_values(self, x: torch.Tensor) -> torch.Tensor:
        """The rows group's entries of a per-row vector, rank-major;
        differentiable."""
        return _GatherRows.apply(x, self.rows_group, self.rows,
                                 self.row_rank)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       summed) -> Dict[str, torch.Tensor]:
        """Metrics as the single-process step reports them: the entries
        named in `summed` are this rank's shares and are summed over the
        rows group; the rest are already the world's values."""
        keys = [k for k in metrics if k in summed]
        if not keys:
            return metrics
        v = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(v, group=self.rows_group)
        out = dict(metrics)
        out.update({k: v[i] for i, k in enumerate(keys)})
        return out

    # ---- expert parallelism -----------------------------------------------

    def exchange_counts(self, counts: torch.Tensor):
        """Each expert rank j gets row j of `counts` [expert, ...] (the rows
        this rank will send it, split as the caller likes).  Returns (the
        counts received, [source rank, ...] on the device; (sent, received)
        as host lists, read in one sync)."""
        got = torch.empty_like(counts)
        dist.all_to_all_single(got, counts.contiguous(),
                               group=self.expert_group)
        sent, received = torch.stack([counts, got]).tolist()
        return got, (sent, received)

    def exchange(self, x: torch.Tensor, send: List[int],
                 recv: List[int]) -> torch.Tensor:
        """Send rows of x [N, ...], grouped by destination, over the expert
        group: `send[j]` rows to expert rank j, `recv[j]` rows from it."""
        return _Exchange.apply(x, send, recv, self.expert_group)

    def exchange_back(self, y: torch.Tensor, send: List[int],
                      recv: List[int]) -> torch.Tensor:
        """The inverse of `exchange`: rows of y [sum(recv), ...] go back to
        the ranks they came from."""
        return _Exchange.apply(y, recv, send, self.expert_group)

    # ---- sharded tensors ---------------------------------------------------

    def shard_groups(self, name: str, param, tensor_dim: Optional[int] = None
                     ) -> Tuple[Tuple[int, ...], Dict[int, list]]:
        """(the parameter's global shape, {dim of its local tensor: [(group,
        group size), ...]}): its FSDP2 dim over fsdp, for an expert tensor
        the expert dim over expert, and `tensor_dim` (its tensor-parallel
        split, parallel/sharding.py `tensor_split`) over tensor."""
        from torch.distributed.tensor import DTensor, Shard

        shape = list(param.shape)
        dims: Dict[int, list] = {}
        if isinstance(param, DTensor):
            for pl in param.placements:
                if isinstance(pl, Shard):
                    dims.setdefault(pl.dim, []).append(
                        (self.fsdp_group, self.fsdp_size))
        if is_expert_key(name):
            shape[0] *= self.expert_size
            dims.setdefault(0, []).append((self.expert_group,
                                           self.expert_size))
        if tensor_dim is not None and self.tensor_size > 1:
            shape[tensor_dim] *= self.tensor_size
            dims.setdefault(tensor_dim, []).append((self.tensor_group,
                                                    self.tensor_size))
        return tuple(shape), dims

def is_expert_key(name: str) -> bool:
    return ".experts." in name or name.startswith("experts.")
