"""Parameter and batch sharding rules, applied with FSDP2 (port of
llavamod_tpu/parallel/sharding.py).

The rule table maps every parameter, by its path, to a PartitionSpec over
the mesh axes, path for path as in the JAX package; it stays the one record
of which tensor belongs to which axis (the `tensor` entries wait for
tensor parallelism, ROADMAP Queue 1, item 13):

  embedding / lm_head [V, D]        -> ((tensor, fsdp), None)  # vocab-dim
  attn in-proj  [D, H*dh]           -> (fsdp, tensor)
  attn out-proj [H*dh, D]           -> (tensor, fsdp)
  mlp in  [D, F]                    -> (fsdp, tensor)
  mlp out [F, D]                    -> (tensor, fsdp)
  moe experts [E, ...]              -> ('expert',) + dense rule
  router [D, E]                     -> (fsdp, None)
  norms / biases / small params     -> replicated
  batch activations [B, T, ...]     -> (('data','fsdp'), None, ...)

`shard_params(mesh, model)` applies it with FSDP2 (`fully_shard`), one unit
per decoder layer, per stacked-expert group, for the vision tower and for
the projector, and the model itself for the rest (embedding, head, final
norm):

  * expert-stacked tensors ([E, D, F]): each rank along `expert` keeps its
    E / expert experts, which FSDP2 shards over fsdp and replicates over
    data;
  * every other parameter: sharded over fsdp, replicated over data and
    expert (HSDP over the flattened data x expert);
  * the dim FSDP2 splits is the rule's fsdp entry (`fsdp_dim`), or dim 0
    where the rule names none or `fit_spec_to_shape` drops it (FSDP2
    splits only dim 0 unevenly).

Gradients are summed over the ranks (no averaging): each rank's loss is
its share of the single-process loss (train/steps.py).  Parameters are
gathered in `compute_dtype` (the mixed-precision policy does the cast that
train/steps.py `_cast_tree` does in a single process) and gradients are
reduced in f32.  int8 weights (`Int8Weight`) are buffers, which FSDP2
leaves whole on every rank.  Both models of a stage are wrapped, the frozen
teacher included.  With one process per card each rank's loader already
yields its own rows, which runtime/prefetch.py puts on the rank's card.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn


class P(tuple):
    """A PartitionSpec: one entry per dim, an axis name, a tuple of axis
    names, or None (replicated)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _spec_for(path: str, ndim: int) -> P:
    """Sharding rule lookup by parameter path ('/'-joined) and rank; the
    JAX package's table, its stacked-layer rows included."""
    is_expert = "/experts/" in path
    is_stacked = "/stacked/" in path
    lead = (["expert"] if is_expert else []) + (["pipe"] if is_stacked else [])
    base_ndim = ndim - len(lead)

    def wrap(spec_dims):
        if is_stacked and is_expert:
            return P("pipe", "expert", *spec_dims)
        return P(*lead, *spec_dims)

    if base_ndim <= 1:
        return wrap([None] * base_ndim)  # norms, biases, scalars

    # vocab-carrying matrices: the vocab dim
    if "embedding" in path or "lm_head" in path:
        return wrap([("tensor", "fsdp"), None])

    # router: tiny, replicate the expert dim
    if path.endswith("router") or path.endswith("coef"):
        return wrap(["fsdp", None])

    # attention
    if "/attn/" in path or "/self_attn/" in path:
        if "wo" in path or "/o/" in path or path.endswith("o/kernel"):
            return wrap(["tensor", "fsdp"] + [None] * (base_ndim - 2))
        return wrap(["fsdp", "tensor"] + [None] * (base_ndim - 2))

    # mlp
    if path.endswith("down") or "down/" in path or "fc2" in path:
        return wrap(["tensor", "fsdp"] + [None] * (base_ndim - 2))
    if (path.endswith("gate") or path.endswith("up") or "fc1" in path
            or "gate/" in path or "up/" in path):
        return wrap(["fsdp", "tensor"] + [None] * (base_ndim - 2))

    # generic 2D+ (projector kernels, vit patch embed, qformer, ...)
    return wrap(["fsdp", None] + [None] * (base_ndim - 2))


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_specs(params: Union[nn.Module, Mapping[str, Any]]) -> Dict[str, P]:
    """{state_dict key: PartitionSpec} for a module's parameters, or for a
    mapping key -> tensor or shape (keys are '.'-joined JAX paths)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: _spec_for(k.replace(".", "/"), len(_shape(v)))
            for k, v in params.items()}


def batch_spec(ndim: int, *, seq_sharded: bool = False) -> P:
    """Batch tensors: shard batch dim over (data, fsdp); scalars replicate."""
    if ndim == 0:
        return P()
    dims = [("data", "fsdp")]
    if seq_sharded and ndim > 1:
        dims.append("tensor")
    dims += [None] * (ndim - len(dims))
    return P(*dims)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, a MeshConfig or a mapping."""
    from llavamod_tpu_torch.parallel.mesh import AXES, MeshConfig

    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, MeshConfig):
        return {a: getattr(mesh, a) for a in AXES}
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def fit_spec_to_shape(mesh, spec: P, shape) -> P:
    """Drop sharding on dims the mesh doesn't divide (replicate instead).

    Rules are written for production shapes; tiny test models (and odd
    vocab/hidden sizes) fall back dim-by-dim to replication."""
    sizes = axis_sizes(mesh)
    fitted = []
    for i, axes in enumerate(spec):
        if axes is None:
            fitted.append(None)
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        if any(a not in sizes for a in ax_tuple):
            fitted.append(None)  # mesh lacks the axis: replicate
            continue
        size = 1
        for a in ax_tuple:
            size *= sizes[a]
        if i < len(shape) and shape[i] % size == 0:
            fitted.append(axes)
        else:
            fitted.append(None)
    return P(*fitted)


def fsdp_dim(mesh, spec: P, shape) -> int:
    """The dim FSDP2 splits: the fitted rule's fsdp entry, else 0."""
    for i, axes in enumerate(fit_spec_to_shape(mesh, spec, shape)):
        if axes == "fsdp" or (isinstance(axes, tuple) and "fsdp" in axes):
            return i
    return 0


def is_sharded(module: nn.Module) -> bool:
    """True for a module that `shard_params` wrapped."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a sharded tensor (a view: in-place updates reach
    the parameter); any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _has_params(module: Optional[nn.Module]) -> bool:
    return module is not None and any(True for _ in module.parameters())


@torch.no_grad()
def _keep_local_experts(experts: nn.Module, rank: int, size: int) -> None:
    """Slice every tensor of a stacked-expert group [E, ...] to this
    expert rank's E / size experts, in place."""
    for mod in experts.modules():
        for store in (mod._parameters, mod._buffers):
            for name, t in list(store.items()):
                if t is None or t.dim() == 0:
                    continue
                e = t.shape[0]
                if e % size:
                    raise ValueError(f"{e} experts do not divide over "
                                     f"expert={size}")
                n = e // size
                part = t[rank * n:(rank + 1) * n].clone()
                if isinstance(t, nn.Parameter):
                    part = nn.Parameter(part, requires_grad=t.requires_grad)
                store[name] = part


def shard_params(mesh, model: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None,
                 ctx=None) -> nn.Module:
    """Wrap `model` (a Llava) with FSDP2 over `mesh` by the rule table, in
    place; returns it.  `ctx` is the mesh's ParallelContext (made here if
    not given)."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    from llavamod_tpu_torch.parallel.collectives import ParallelContext

    ctx = ctx or ParallelContext(mesh)
    sizes = axis_sizes(mesh)
    llm = getattr(model, "llm", None)
    layers = list(llm.layers) if llm is not None else []
    for layer in layers:
        if getattr(layer, "is_moe", False):
            _keep_local_experts(layer.mlp.experts, ctx.expert_rank,
                                ctx.expert_size)
    names = {id(p): k for k, p in model.named_parameters()}
    specs = param_specs(model)

    def placement(param):
        key = names[id(param)]
        shape = list(param.shape)
        if ".experts." in key:
            shape[0] *= ctx.expert_size      # the rule is for all E experts
        return Shard(fsdp_dim(sizes, specs[key], shape))

    policy = MixedPrecisionPolicy(param_dtype=compute_dtype,
                                  reduce_dtype=torch.float32,
                                  cast_forward_inputs=False)
    kw = dict(mp_policy=policy, shard_placement_fn=placement)
    units = []
    for layer in layers:
        experts = getattr(layer.mlp, "experts", None) \
            if getattr(layer, "is_moe", False) else None
        if _has_params(experts):
            units.append(fully_shard(experts, mesh=ctx.expert_param_mesh,
                                     **kw))
        if _has_params(layer):
            units.append(fully_shard(layer, mesh=ctx.param_mesh, **kw))
    for name in ("vision", "projector"):
        sub = getattr(model, name, None)
        if _has_params(sub) and hasattr(type(sub), "forward") \
                and type(sub).forward is not nn.Module.forward:
            units.append(fully_shard(sub, mesh=ctx.param_mesh, **kw))
    units.append(fully_shard(model, mesh=ctx.param_mesh, **kw))
    for unit in units:
        # sum the gradients over the ranks: each rank's loss is its share
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    return model
