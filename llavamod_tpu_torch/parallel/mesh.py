"""Device mesh construction (port of llavamod_tpu/parallel/mesh.py).

The reference scales with DeepSpeed ZeRO (data parallel) + DeepSpeed-MoE
expert parallel over NCCL, one process per GPU (SURVEY.md §2.10).  The JAX
package puts all parallelism in one `jax.sharding.Mesh`; here it is one
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks, one rank
per card, with the same five axes in the same order:

  pipe   — pipeline parallelism: each rank along it keeps a contiguous
           block of the decoder's layers and runs them as one stage of a
           GPipe microbatch schedule (parallel/pipeline.py)
  data   — data parallelism: every rank owns distinct rows
  fsdp   — parameter / gradient / optimizer sharding (ZeRO-3, FSDP2)
  expert — expert parallelism: each rank along it keeps E / expert experts
  tensor — tensor parallelism: each rank along it keeps a slice of every
           attention, MLP and expert matrix and of the vocabulary, and
           holds the same rows (with sequence parallelism, a T-shard of
           the residual stream between the blocks)

The global batch is the rows of data x fsdp x expert, and a step on it
computes the single-process step on those rows (parallel/sharding.py,
parallel/collectives.py); the ranks along pipe and along tensor hold the
same rows.  `pipe` is outermost, as in the JAX package: its traffic is one
point-to-point transfer of a microbatch's activations per stage boundary,
the lightest of the axes, so the ranks of one stage are consecutive.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

AXES = ("pipe", "data", "fsdp", "expert", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    tensor: int = 1
    pipe: int = 1

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.expert * self.tensor * self.pipe

    @classmethod
    def auto(cls, n_devices: Optional[int] = None, *, expert: int = 1,
             tensor: int = 1) -> "MeshConfig":
        """All remaining ranks go to fsdp (the usual single-node choice)."""
        n = n_devices or world_size()
        assert n % (expert * tensor) == 0
        return cls(data=1, fsdp=n // (expert * tensor), expert=expert,
                   tensor=tensor)


def world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """The world's ranks as a DeviceMesh of shape (pipe, data, fsdp, expert,
    tensor) named AXES; rank = ((((p * data + d) * fsdp + f) * expert + e)
    * tensor + t).  Needs an initialised process group of `cfg.size`
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = cfg or MeshConfig.auto()
    n = world_size()
    assert cfg.size == n, f"mesh {cfg} needs {cfg.size} ranks, have {n}"
    return init_device_mesh(
        device_type, (cfg.pipe, cfg.data, cfg.fsdp, cfg.expert, cfg.tensor),
        mesh_dim_names=AXES)


def mesh_config(mesh) -> MeshConfig:
    """The MeshConfig of a DeviceMesh made by `make_mesh`."""
    return MeshConfig(**{a: mesh.size(i) for i, a in enumerate(AXES)})


def rank_grid(cfg: MeshConfig) -> torch.Tensor:
    """Ranks laid out [pipe, data, fsdp, expert, tensor]."""
    return torch.arange(cfg.size).reshape(cfg.pipe, cfg.data, cfg.fsdp,
                                          cfg.expert, cfg.tensor)
