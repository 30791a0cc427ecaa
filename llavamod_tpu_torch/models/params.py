"""Parameter containers shared by the port's modules.

A `ParamGroup` is the counterpart of one dict of the JAX param tree: its
attribute names are the dict keys, so nesting modules reproduces the JAX
paths as state_dict keys.  `Initializer` draws seeded weights on one device
and dtype; a torch.Generator stands in for the JAX key (the two give
different numbers from one seed, so parity tests load JAX weights instead).
Parameters are built trainable, the frozen vision tower excepted; a
training step freezes the rest of what its train set leaves out
(llavamod_tpu_torch/train/optim.py `apply_trainable_mask`).
"""

from __future__ import annotations

import torch
from torch import nn


class ParamGroup(nn.Module):
    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


class Initializer:
    def __init__(self, generator: torch.Generator, device=None,
                 dtype=torch.float32):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.g, device=self.device,
                        dtype=torch.float32)
        return (x * std).to(self.dtype)

    def dense(self, d_in: int, d_out: int) -> torch.Tensor:
        """[d_in, d_out] with std d_in**-0.5 (the JAX package's dense init)."""
        return self.normal((d_in, d_out), d_in ** -0.5)

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, *shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)
