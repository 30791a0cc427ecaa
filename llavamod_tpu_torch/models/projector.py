"""Multimodal projectors: vision features -> LLM embedding space (port of
llavamod_tpu/models/projector.py for 'linear', 'mlp{N}x_gelu' and
'identity'; 'mlp2x_gelu' is the configuration of record).

`build_projector(spec, vision_dim, llm_dim)` returns a Projector whose
`init(generator, device, dtype)` builds the parameter module (state_dict
keys as the JAX tree: 'kernel'/'bias' for linear, 'layers.{i}.kernel' for
the MLP) and whose `apply(module, x)` runs it.  The GELU is exact
(approximate=False), as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Callable, NamedTuple

import torch
from torch import nn

from llavamod_tpu_torch.models.params import Initializer, ParamGroup


class Projector(NamedTuple):
    spec: str
    init: Callable[..., nn.Module]     # (generator, device, dtype) -> module
    apply: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    num_output_tokens: Callable[[int], int]  # input tokens -> output tokens


def _dense(ini: Initializer, din: int, dout: int) -> ParamGroup:
    return ParamGroup(kernel=ini.dense(din, dout), bias=ini.zeros(dout))


def _apply_dense(p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    return x @ p.kernel + p.bias


def _mlp_init(din: int, dout: int, depth: int):
    def init(generator, device=None, dtype=torch.float32) -> nn.Module:
        ini = Initializer(generator, device, dtype)
        m = nn.Module()
        m.layers = nn.ModuleList(
            [_dense(ini, din, dout)]
            + [_dense(ini, dout, dout) for _ in range(1, depth)])
        return m
    return init


def _mlp_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = _apply_dense(p.layers[0], x)
    for lp in p.layers[1:]:
        x = _apply_dense(lp, nn.functional.gelu(x, approximate="none"))
    return x


def build_projector(spec: str, vision_dim: int, llm_dim: int) -> Projector:
    """Parse a projector spec string and return (init, apply)."""
    if spec == "identity":
        return Projector(spec, lambda generator, device=None,
                         dtype=torch.float32: nn.Module(),
                         lambda p, x: x, lambda n: n)
    if spec == "linear":
        return Projector(
            spec,
            lambda generator, device=None, dtype=torch.float32: _dense(
                Initializer(generator, device, dtype), vision_dim,
                llm_dim),
            _apply_dense, lambda n: n)
    m = re.match(r"^mlp(\d+)x_gelu$", spec)
    if m:
        return Projector(spec, _mlp_init(vision_dim, llm_dim, int(m.group(1))),
                         _mlp_apply, lambda n: n)
    raise ValueError(f"Unknown or not yet ported projector type: {spec}")
