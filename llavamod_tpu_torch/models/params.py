"""Parameter containers shared by the port's modules.

A `ParamGroup` is the counterpart of one dict of the JAX param tree: its
attribute names are the dict keys, so nesting modules reproduces the JAX
paths as state_dict keys.  `Initializer` draws seeded weights on one device
and dtype; a torch.Generator stands in for the JAX key (the two give
different numbers from one seed, so parity tests load JAX weights instead).
Parameters are built trainable, the frozen vision tower excepted; a
training step freezes the rest of what its train set leaves out
(llavamod_tpu_torch/train/optim.py `apply_trainable_mask`).  A group's
functional forward runs through its module call (`ParamGroup.forward`,
`apply_through`), so a sharded group gathers its parameters first.  An
`Int8Weight` takes the place of a float weight that the int8 quantizers
(models/llm/decoder.py) replaced.
"""

from __future__ import annotations

import torch
from torch import nn


class ParamGroup(nn.Module):
    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs), run through the module call so that
        the module's hooks (FSDP2's gather and reshard, parallel/sharding.py)
        fire around the functional forwards that read its parameters."""
        return fn(self, *args, **kwargs)


def apply_through(module: nn.Module, fn, *args, **kwargs):
    """fn(module, *args, **kwargs), through the module call where the
    module is a ParamGroup."""
    if isinstance(module, ParamGroup):
        return module(fn, *args, **kwargs)
    return fn(module, *args, **kwargs)


class Int8Weight(nn.Module):
    """An int8-quantized weight, the JAX dict {'w_int8', 'scale'} (plus
    'dtype_ref' for the int8 embedding; llavamod_tpu/models/llm/decoder.py
    `quantize_dense_int8`, `quantize_head_int8`, `quantize_experts_int8`).

    Its tensors are buffers, not parameters: the optimizer, the trainable
    mask and the compute-dtype cast (train/steps.py `_cast_tree`) see only
    parameters, so a quantized weight is frozen by construction, as the
    JAX int leaves take float0 cotangents.  `scale` stays f32 through
    `.to(dtype)`: the JAX `_cast_tree` exempts it, since it multiplies the
    int32 accumulators.  `dtype_ref` is a zero-size tensor carrying the
    activation dtype that the int8 embedding dequantizes to."""

    def __init__(self, w_int8: torch.Tensor, scale: torch.Tensor,
                 dtype_ref: "torch.Tensor | None" = None):
        super().__init__()
        self.register_buffer("w_int8", w_int8)
        self.register_buffer("scale", scale.float())
        if dtype_ref is not None:
            self.register_buffer("dtype_ref", dtype_ref)

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:
            self.scale = scale.to(self.scale.device, torch.float32)
        return self


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
