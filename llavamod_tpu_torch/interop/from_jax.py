"""Carry JAX parameter trees into the port's modules.

The port's modules keep the JAX param-tree paths (joined by '.') as
state_dict keys and the JAX layouts as tensor shapes, so the conversion is
leaf for leaf.  This module imports no jax: it takes the tree after
`jax.device_get`, i.e. nested dicts/lists of numpy arrays, and gives back
flat numpy state (`numpy_from_state_dict`) for leaf-for-leaf comparisons.
A quantized JAX tree (its {'w_int8', 'scale'} dicts) loads the same way
into a module quantized with the same flags
(models/llm/decoder.py `quantize_decoder_int8`), whose `Int8Weight`
buffers carry those paths.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _to_tensor(leaf: Any) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_numpy(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict/list of arrays -> flat {'a.b.0.c': tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _to_tensor(tree)}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(state_dict_from_numpy(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX tree into `module` (strict: every key on both sides),
    casting to each parameter's device and dtype."""
    module.load_state_dict(state_dict_from_numpy(tree), strict=True)
    return module


def numpy_from_state_dict(module: nn.Module) -> Dict[str, np.ndarray]:
    """The way back: {state_dict key: f32 ndarray on the host} (bf16 leaves
    are widened exactly), keyed as `state_dict_from_numpy` keys a JAX tree.  The
    arrays are copies: later in-place updates of the module leave them."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in module.state_dict().items()}
