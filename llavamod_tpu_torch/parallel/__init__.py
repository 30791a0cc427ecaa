"""Multi-process training over torch.distributed (port of
llavamod_tpu/parallel/): the mesh (`mesh.py`), the sharding rules applied
with FSDP2 (`sharding.py`), the collectives of the step
(`collectives.py`) and the GPipe pipeline over the pipe axis
(`pipeline.py`).  Data, fsdp, expert, tensor, sequence and pipeline
parallelism run, with LoRA adapters (placed beside the sharded model) on
any of them and the fused step (which gathers and reduces each FSDP2 unit
itself) on all but the pipeline, as in the JAX package."""

from llavamod_tpu_torch.parallel.mesh import AXES, MeshConfig, make_mesh
from llavamod_tpu_torch.parallel.sharding import (
    batch_spec,
    param_specs,
    shard_params,
)

__all__ = ["AXES", "MeshConfig", "make_mesh", "batch_spec", "param_specs",
           "shard_params"]
