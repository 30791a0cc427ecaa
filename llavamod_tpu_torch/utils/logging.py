"""Logging helpers (port of llavamod_tpu/utils/logging.py: `rank0_print`).

The rank is torch.distributed's where a process group is initialised, else
0, so a single process always prints.
"""

from __future__ import annotations


def process_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank0_print(*args, **kwargs):
    """Print only from rank 0."""
    if process_rank() == 0:
        print(*args, **kwargs)
