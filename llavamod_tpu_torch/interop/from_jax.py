"""Carry JAX parameter trees into the port's modules.

The port's modules keep the JAX param-tree paths (joined by '.') as
state_dict keys and the JAX layouts as tensor shapes, so the conversion is
leaf for leaf.  This module imports no jax: it takes the tree after
`jax.device_get`, i.e. nested dicts/lists of numpy arrays, and gives back
flat numpy state (`numpy_from_state_dict`) for leaf-for-leaf comparisons.
A quantized JAX tree (its {'w_int8', 'scale'} dicts) loads the same way
into a module quantized with the same flags
(models/llm/decoder.py `quantize_decoder_int8`), whose `Int8Weight`
buffers carry those paths.  A pre-stacked JAX layer tree
({'stacked': [...]}) is unstacked with the JAX package's
`decoder.unstack_layers` first.  A JAX LoRA tree (models/lora.py
`init_lora`: {'a', 'b'} at the targets, None elsewhere) loads into the
port's `LoraAdapters`, whose keys are the targets' paths plus '.a' /
'.b'.  `adafactor_state_from_jax` reads optax's
factored Adafactor statistics into the port's per-parameter state
(train/adafactor.py).
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


def state_dict_from_numpy(tree: Any, prefix: str = "",
                          python_leaves: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Nested dict/list of arrays -> flat {'a.b.0.c': tensor}.  `None`
    leaves (the non-target entries of a LoRA tree) are skipped, and so are
    Python bool / int leaves without `python_leaves` (the simple
    projector's `same` and `heads`, module config in the port)."""
    if tree is None or (not python_leaves and isinstance(tree, (bool, int))):
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _to_tensor(tree)}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(state_dict_from_numpy(
            v, f"{prefix}.{k}" if prefix else str(k), python_leaves))
    return out


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX tree into `module` (strict: every key on both sides),
    casting to each parameter's device and dtype."""
    module.load_state_dict(state_dict_from_numpy(tree, python_leaves=False),
                           strict=True)
    return module


def numpy_from_state_dict(module: nn.Module) -> Dict[str, np.ndarray]:
    """The way back: {state_dict key: f32 ndarray on the host} (bf16 leaves
    are widened exactly), keyed as `state_dict_from_numpy` keys a JAX tree.  The
    arrays are copies: later in-place updates of the module leave them."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def adafactor_state_from_jax(factored: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax's FactoredState (its v_row / v_col / v trees, after
    `jax.device_get`) -> {state_dict key: {'v_row', 'v_col'} or {'v'}}, f32,
    the layout of train/adafactor.py `init_leaf`.  optax fills the fields a
    leaf does not use with (1,) placeholders: a factored leaf's v_row has
    the parameter's shape less one axis, never (1,).  Leaves that optax
    masked out (frozen parameters) carry no arrays and get no entry."""
    rows, cols, vs = (state_dict_from_numpy(t) for t in
                      (factored.v_row, factored.v_col, factored.v))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in vs.items():
        if tuple(rows[k].shape) != (1,):
            out[k] = {"v_row": rows[k].float(), "v_col": cols[k].float()}
        else:
            out[k] = {"v": v.float()}
    return out
