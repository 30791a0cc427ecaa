"""Multi-process training over torch.distributed (port of
llavamod_tpu/parallel/): the mesh (`mesh.py`), the sharding rules applied
with FSDP2 (`sharding.py`) and the collectives of the step
(`collectives.py`).  Data, fsdp, expert, tensor and sequence parallelism
run, with the fused step (which gathers and reduces each FSDP2 unit
itself) and LoRA adapters (placed beside the sharded model) on any of
them; pipeline parallelism (ROADMAP Queue 1, item 14) raises."""

from llavamod_tpu_torch.parallel.mesh import AXES, MeshConfig, make_mesh
from llavamod_tpu_torch.parallel.sharding import (
    batch_spec,
    param_specs,
    shard_params,
)

__all__ = ["AXES", "MeshConfig", "make_mesh", "batch_spec", "param_specs",
           "shard_params"]
