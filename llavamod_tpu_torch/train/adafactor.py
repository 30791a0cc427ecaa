"""Adafactor as plain leaf functions (port of llavamod_tpu/train/adafactor.py).

One rule serves both training paths: the standard path's `Adafactor`
optimizer group (train/optim.py) applies it to every trainable parameter
after the backward, and the fused step (train/fused_steps.py) applies it
to one layer's parameters inside the backward, as soon as their gradients
exist.  The group keeps the state per parameter name, for the trainable
parameters only (the JAX `init_tree` / `update_tree` over a masked tree):
a frozen parameter has no state and is never touched.

Semantics mirror optax.adafactor (scale_by_factored_rms +
clip_by_block_rms + lr + scale_by_param_block_rms, Shazeer & Stern 2018)
with the JAX package's settings: decay rate 0.8, update clipping at 1.0,
parameter scale on, no momentum.  Statistics and arithmetic are f32
whatever the parameter's dtype (optax keeps the statistics in the
parameter's dtype; in f32 the two agree).  The block of the update
clipping and of the parameter scale is one parameter tensor: the port has
no layer stacking, so a block is one layer's matrix (or one layer's
stacked experts) on both paths, as in the JAX fused step and in the JAX
trainer with `prestack_layers=False`.

On a sharded parameter (`shards`: the global shape and, per dim of the
rank's shard, the groups it is split over) the rule runs on the shard: a
mean over a split dim, or over the whole tensor, sums the shard's part and
all-reduces it over those groups; the statistics are the shards of the
single-process ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_EPS = 1e-30          # optax adafactor eps (regularizer on grad^2)
_MIN_PARAM_SCALE = 1e-3  # optax scale_by_param_block_rms min_scale
_MIN_DIM_TO_FACTOR = 128


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """The two largest axes to reduce over, or None (optax's rule: the
    later axis wins a tie, as numpy's stable argsort orders them)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return order[-2], order[-1]


def init_leaf(param: torch.Tensor, global_shape=None
              ) -> Dict[str, torch.Tensor]:
    """Factored state for one parameter: {'v_row', 'v_col'} or {'v'}, f32;
    for the shard of a sharded one, which factors by `global_shape`."""
    fd = _factored_dims(tuple(global_shape or param.shape))
    shape = tuple(param.shape)
    if fd is not None:
        d1, d0 = fd
        zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                      device=param.device)
        return {"v_row": zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": zeros(shape[:d1] + shape[d1 + 1:])}
    return {"v": torch.zeros(shape, dtype=torch.float32, device=param.device)}


def _split(shards, dim: int):
    """The groups of size > 1 that split `dim` of a shard."""
    if shards is None:
        return []
    return [g for g, size in shards[1].get(dim, ()) if size > 1]


def _mean(x: torch.Tensor, dim: int, shards, keepdim: bool = False):
    """x.mean(dim) of the whole tensor whose shard `x` is."""
    groups = _split(shards, dim)
    if not groups:
        return x.mean(dim=dim, keepdim=keepdim)
    s = x.sum(dim=dim, keepdim=keepdim)
    for g in groups:
        torch.distributed.all_reduce(s, group=g)
    return s / shards[0][dim]


def _mean_all(x: torch.Tensor, shards):
    """x.mean() of the whole tensor whose shard `x` is."""
    groups = [g for d in range(x.dim()) for g in _split(shards, d)]
    if not groups:
        return x.mean()
    s = x.sum()
    for g in groups:
        torch.distributed.all_reduce(s, group=g)
    n = 1
    for size in shards[0]:
        n *= size
    return s / n


def _drop(shards, dim: int):
    """The shards of a statistic that reduced `dim` away."""
    if shards is None:
        return None
    shape, dims = shards
    return (shape[:dim] + shape[dim + 1:],
            {(d if d < dim else d - 1): g for d, g in dims.items()
             if d != dim})


@torch.no_grad()
def update_leaf(param: torch.Tensor, grad: torch.Tensor,
                state: Dict[str, torch.Tensor], count: int, lr: float, *,
                decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                multiply_by_parameter_scale: bool = True,
                weight_decay_rate: Optional[float] = None,
                shards=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Adafactor step for one parameter at update `count` (0 for the
    first).  Returns (new parameter in the parameter's dtype, new state);
    the inputs are left as they are.  `shards` = (global shape, {dim:
    [(group, size), ...]}) when param / grad / state are a rank's shards."""
    g = grad.float()
    p32 = param.float()
    t = torch.tensor(count + 1.0, dtype=torch.float32)
    decay_rate_t = float(1.0 - t ** (-decay_rate))

    fd = _factored_dims(tuple(shards[0] if shards else param.shape))
    grad_sqr = g * g + _EPS
    if fd is not None:
        d1, d0 = fd
        v_row = (decay_rate_t * state["v_row"]
                 + (1.0 - decay_rate_t) * _mean(grad_sqr, d0, shards))
        v_col = (decay_rate_t * state["v_col"]
                 + (1.0 - decay_rate_t) * _mean(grad_sqr, d1, shards))
        new_state = {"v_row": v_row, "v_col": v_col}
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = _mean(v_row, reduced_d1, _drop(shards, d0),
                             keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        update = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
    else:
        v = decay_rate_t * state["v"] + (1.0 - decay_rate_t) * grad_sqr
        new_state = {"v": v}
        update = g * v ** -0.5

    if clipping_threshold is not None:
        clip_denom = torch.clamp_min(
            torch.sqrt(_mean_all(update * update, shards))
            / clipping_threshold, 1.0)
        update = update / clip_denom
    update = update * lr
    if multiply_by_parameter_scale:
        scale = torch.clamp_min(torch.sqrt(_mean_all(p32 * p32, shards)),
                                _MIN_PARAM_SCALE)
        update = update * scale
    if weight_decay_rate:
        update = update + weight_decay_rate * p32
    return (p32 - update).to(param.dtype), new_state
