"""The process groups of a mesh and the collectives the training step runs
on them.

`ParallelContext(mesh)` holds, for one rank of a `make_mesh` mesh:

  * `param_mesh` — 2-D (data x expert, fsdp): FSDP2 shards every parameter
    but the experts over fsdp and replicates it over data and expert (HSDP);
  * `expert_param_mesh` — 2-D (data, fsdp) of the rank's own expert slot:
    the experts a rank keeps (E / expert of them) are sharded over fsdp and
    replicated over data;
  * the `expert` and `fsdp` groups, and the world, whose ranks all own
    distinct rows (pipe = tensor = 1).

While a context is `active`, the MoE block gates the world's tokens as one
set (`gather_rows`) and sends each kept token to the rank that owns its
expert (`exchange`), and the losses divide by the world's token counts
(`all_sum`).  Outside one, every function of the model runs as in a single
process.  The gradient of each collective is its transpose: the gather's
is the sum over ranks of the gathered rows' cotangents, the exchange's the
inverse exchange.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from llavamod_tpu_torch.parallel.mesh import mesh_config, rank_grid

_ACTIVE: List["ParallelContext"] = []


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


class ParallelContext:
    def __init__(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh

        self.mesh = mesh
        self.cfg = cfg = mesh_config(mesh)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.device_type = mesh.device_type
        grid = rank_grid(cfg)[0, :, :, :, 0]                   # [D, F, X]
        self.param_mesh = DeviceMesh(
            self.device_type,
            grid.permute(0, 2, 1).reshape(cfg.data * cfg.expert, cfg.fsdp),
            mesh_dim_names=("data_expert", "fsdp"))
        self.expert_param_mesh = DeviceMesh(
            self.device_type, grid.permute(2, 0, 1),
            mesh_dim_names=("expert", "data", "fsdp"))["data", "fsdp"]
        self.expert_group = mesh.get_group("expert")
        self.fsdp_group = mesh.get_group("fsdp")
        self.expert_size = cfg.expert
        self.expert_rank = mesh.get_local_rank("expert")
        self.fsdp_size = cfg.fsdp
        self.segments = 1

    # ---- the world's rows -------------------------------------------------

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of `x` over the world (no gradient): token counts."""
        y = x.detach().clone()
        dist.all_reduce(y)
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
        """(the world's rows of x [S, ...] in the single-process order,
        the indices of this rank's rows in it).  Differentiable in x."""
        s, m, w = x.shape[0], self.segments, self.world
        full = _GatherRows.apply(x, None, w, self.rank)
        per = s // m
        if m > 1:
            full = full.reshape((w, m, per) + tuple(x.shape[1:])).transpose(
                0, 1).reshape((w * s,) + tuple(x.shape[1:]))
        idx = (torch.arange(m, device=x.device)[:, None] * (w * per)
               + self.rank * per
               + torch.arange(per, device=x.device)[None, :]).reshape(-1)
        return full, idx

    def gather_values(self, x: torch.Tensor) -> torch.Tensor:
        """The world's entries of a per-row vector, rank-major;
        differentiable."""
        return _GatherRows.apply(x, None, self.world, self.rank)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       summed) -> Dict[str, torch.Tensor]:
        """Metrics as the single-process step reports them: the entries
        named in `summed` are this rank's shares and are summed over the
        world; the rest are already the world's values."""
        keys = [k for k in metrics if k in summed]
        if not keys:
            return metrics
        v = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(v)
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

    def shard_groups(self, name: str, param) -> Tuple[Tuple[int, ...],
                                                      Dict[int, list]]:
        """(the parameter's global shape, {dim of its local tensor: [(group,
        group size), ...]}): its FSDP2 dim over fsdp and, for an expert
        tensor, the expert dim over expert."""
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
        return tuple(shape), dims


def is_expert_key(name: str) -> bool:
    return ".experts." in name or name.startswith("experts.")
