"""Parameter and batch sharding rules, applied with FSDP2 (port of
llavamod_tpu/parallel/sharding.py).

The rule table maps every parameter, by its path, to a PartitionSpec over
the mesh axes, path for path as in the JAX package; it stays the one record
of which tensor belongs to which axis:

  embedding / lm_head [V, D]        -> ((tensor, fsdp), None)  # vocab-dim
  attn in-proj  [D, H*dh]           -> (fsdp, tensor)
  attn out-proj [H*dh, D]           -> (tensor, fsdp)
  mlp in  [D, F]                    -> (fsdp, tensor)
  mlp out [F, D]                    -> (tensor, fsdp)
  moe experts [E, ...]              -> ('expert',) + dense rule
  router [D, E]                     -> (fsdp, None)
  norms / biases / small params     -> replicated
  batch activations [B, T, ...]     -> (('data','fsdp'), None, ...)

`shard_params(mesh, model)` first keeps, under pipe > 1, only the decoder
layers of the rank's pipeline stage (parallel/pipeline.py
`keep_stage_layers`: a contiguous block of layer repeats, the rule's
`pipe` lead of the stacked layer tree), then the rank's slice of every LLM
tensor that the rule names `tensor` for (`tensor_split`, Megatron-LM's
layout: attention in-projections on their output dim and `wo` on its input
dim, so each rank holds H / tensor query and KH / tensor KV heads;
`gate` / `up` on F and `down` on its input F, stacked experts included; the
embedding and a separate head on the vocab dim), then applies the rest
with FSDP2 (`fully_shard`), one unit per decoder layer, per stacked-expert
group, for the vision tower and for the projector, and the model itself
for the rest (embedding, head, final norm).  Where the port departs from
the table: the 1-D q / k / v biases, `up_bias`, an int8 weight's output
scales and the head's bias and scales follow their matrix's split (the
table replicates every 1-D tensor; a bias added to a column slice must be
that slice's); the fused int8 `wqkv` and `gate_up` are split per block
(q, k, v; gate, up) and each rank's blocks concatenated, since a
contiguous split of the fused columns would hand a rank other heads, or
gate without up; and the vision tower, whose attention and MLP rows name
`tensor` too, stays whole on every tensor rank with the projector (it is
frozen, and the image splice runs on the full sequence).  A head count,
KV head count, FFN width or vocabulary that `tensor` does not divide is
refused (the JAX package replicates such a dim, `fit_spec_to_shape`).
FSDP2:

  * expert-stacked tensors ([E, D, F]): each rank along `expert` keeps its
    E / expert experts, which FSDP2 shards over fsdp and replicates over
    data;
  * every other parameter: sharded over fsdp, replicated over data and
    expert (HSDP over the flattened data x expert);
  * the dim FSDP2 splits is the rule's fsdp entry (`fsdp_dim`), or dim 0
    where the rule names none or `fit_spec_to_shape` drops it (FSDP2
    splits only dim 0 unevenly);
  * every mesh of the FSDP2 units is the one of the rank's pipe and tensor
    index: FSDP2 shards and reduces over data x fsdp x expert only, and
    sees the tensor slice as the whole parameter;
  * everything outside the decoder layers (embedding, tower, projector,
    final norm, head) is whole on every pipe stage, as the rule table
    replicates it over pipe; its gradients are stage 0's, handed to the
    other stages (parallel/pipeline.py `replicated_grads`).  Both models
    keep their stage's layers, the frozen teacher included.  Where the port
    departs from the JAX engine: under LoRA the JAX engine leaves the layer
    trees unstacked, so they (and their adapters) are replicated over pipe
    and gathered by GSPMD each step; here a stage keeps its layers and
    their adapters in every case (`shard_lora`).

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

import contextlib
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

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


@contextlib.contextmanager
def gathered(*modules: Optional[nn.Module]):
    """Within the block the FSDP2 units among `modules` hold their whole
    parameters (one all-gather each, in the compute dtype), registered on
    the modules as plain parameters; they are resharded on exit.  Other
    modules (and None) are left as they are."""
    units = [m for m in modules if m is not None and is_sharded(m)]
    for unit in units:
        unit.unshard()
    try:
        yield
    finally:
        for unit in reversed(units):
            unit.reshard()


def hand_driven(model: nn.Module) -> None:
    """Leave the gathers, reshards and gradient reductions of every FSDP2
    unit of `model` to the caller (`gathered`, `reduce_to_shard`): a
    module call that still fires a unit's hooks then neither reshards nor
    reduces.  For a step that drives its own layer loop and takes its
    gradients with `torch.autograd.grad` (train/fused_steps.py)."""
    if is_sharded(model):
        model.set_reshard_after_forward(False, recurse=True)
        model.set_reshard_after_backward(False, recurse=True)
        model.set_requires_gradient_sync(False, recurse=True)


def reduce_to_shard(grad: torch.Tensor, param: torch.Tensor, name: str,
                    pctx, tensor_partial: bool = False) -> torch.Tensor:
    """The rank's shard, in f32, of the sum of `grad` (the gradient of the
    whole, gathered parameter `name` from this rank's rows) over the ranks
    that hold other rows of it, as FSDP2 reduces a unit's gradients:
    reduce-scatter over fsdp along the parameter's FSDP2 dim (padded where
    fsdp does not divide it, as FSDP2 pads), then all-reduce over the
    replicas (data x expert; data for an expert rank's own experts).
    `tensor_partial`: `grad` is this rank's part of a sum over the tensor
    group (a replicated parameter under sequence parallelism), summed there
    first.  `param` is the sharded parameter, whose local shape the result
    has."""
    from torch.distributed.tensor import DTensor, Shard

    from llavamod_tpu_torch.parallel.collectives import is_expert_key

    dist = torch.distributed
    g = grad.float()
    if tensor_partial and pctx.tensor_size > 1:
        g = g.clone()
        dist.all_reduce(g, group=pctx.tensor_group)
    local = local_tensor(param)
    dim = next((pl.dim for pl in getattr(param, "placements", ())
                if isinstance(pl, Shard)), None) \
        if isinstance(param, DTensor) else None
    if dim is not None and pctx.fsdp_size > 1:
        f = pctx.fsdp_size
        n = g.shape[dim]
        per = -(-n // f)
        x = g.movedim(dim, 0)
        if per * f != n:
            x = torch.cat([x, x.new_zeros((per * f - n,) + x.shape[1:])])
        out = x.new_empty((per,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=pctx.fsdp_group)
        g = out[:local.shape[dim]].movedim(0, dim)
    if is_expert_key(name):
        group, size = pctx.expert_param_mesh.get_group("data"), \
            pctx.cfg.data
    else:
        group, size = pctx.param_mesh.get_group("data_expert"), \
            pctx.cfg.data * pctx.expert_size
    if size > 1:
        g = g.contiguous()
        dist.all_reduce(g, group=group)
    return g.contiguous()


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


# ---------------------------------------------------------------------------
# tensor parallelism: the rank's slices
# ---------------------------------------------------------------------------

class TensorSplit(NamedTuple):
    """How `tensor` splits one tensor: along `dim`, contiguously, or for a
    fused weight per block (`parts`: the blocks' sizes along `dim`, each
    split on its own and the rank's pieces concatenated)."""
    dim: int
    parts: Optional[Tuple[int, ...]] = None


# 1-D biases that follow the output split of their matrix
_COLUMN_BIASES = {"bq": "wq", "bk": "wk", "bv": "wv", "up_bias": "up"}


def _tensor_dim(spec: P) -> Optional[int]:
    for i, axes in enumerate(spec):
        if axes == "tensor" or (isinstance(axes, tuple) and "tensor" in axes):
            return i
    return None


def _fused_parts(name: str, cfg) -> Optional[Tuple[int, ...]]:
    if name == "wqkv":
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        return (q, kv, kv)
    if name == "gate_up":
        return (cfg.intermediate_size, cfg.intermediate_size)
    return None


def check_tensor_parallel(cfg, tensor: int) -> None:
    """Raise ValueError unless `tensor` divides the heads, the KV heads,
    the FFN width and the vocabulary of the decoder config `cfg`."""
    dims = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.intermediate_size,
            "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in dims.items() if v % tensor}
    if bad:
        raise ValueError(f"--tensor_parallel {tensor} does not divide "
                         f"{bad} of {cfg.name}")


def tensor_split(llm: nn.Module, cfg,
                 prefix: str = "llm.") -> Dict[str, TensorSplit]:
    """{state_dict key: TensorSplit} of every parameter and buffer of the
    decoder `llm` that the tensor axis splits (keys under `prefix`)."""
    out: Dict[str, TensorSplit] = {}
    entries = list(llm.named_parameters()) + list(llm.named_buffers())
    found = {k: t for k, t in entries}
    for key, t in entries:
        parts_ = key.split(".")
        name, parent = parts_[-1], parts_[:-1]
        path = (prefix + key).replace(".", "/")
        split = None
        if name == "dtype_ref":
            continue
        if name == "scale":                        # an Int8Weight's scales
            w = found.get(".".join(parent + ["w_int8"]))
            wsplit = (_tensor_dim(_spec_for(path[:-len("scale")] + "w_int8",
                                            w.dim()))
                      if w is not None else None)
            if wsplit is not None and wsplit == w.dim() - 1:
                split = TensorSplit(t.dim() - 1,
                                    _fused_parts(parent[-1], cfg))
            elif wsplit == 0 and w.dim() == 2 and t.dim() == 1 and (
                    "lm_head" in path or "embed" in path):
                split = TensorSplit(0)
        elif name in _COLUMN_BIASES:
            split = TensorSplit(t.dim() - 1)
        elif name == "bias" and parent[-1:] == ["lm_head"]:
            split = TensorSplit(0)
        elif t.dim() >= 2:
            dim = _tensor_dim(_spec_for(path, t.dim()))
            if dim is not None:
                fused = parent[-1] if name == "w_int8" else name
                split = TensorSplit(dim, _fused_parts(fused, cfg))
        if split is not None:
            out[prefix + key] = split
    return out


def take_slice(t: torch.Tensor, split: TensorSplit, rank: int,
               size: int) -> torch.Tensor:
    """Rank `rank`'s slice of the whole tensor `t` (a view)."""
    if split.parts is None:
        return t.chunk(size, dim=split.dim)[rank]
    pieces = t.split(list(split.parts), dim=split.dim)
    return torch.cat([p.chunk(size, dim=split.dim)[rank] for p in pieces],
                     dim=split.dim)


def join_slices(slices, split: TensorSplit) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order (the inverse
    of `take_slice`)."""
    if split.parts is None:
        return torch.cat(slices, dim=split.dim)
    size = len(slices)
    per = [p // size for p in split.parts]
    pieces = [s.split(per, dim=split.dim) for s in slices]
    return torch.cat([torch.cat([pc[j] for pc in pieces], dim=split.dim)
                      for j in range(len(per))], dim=split.dim)


@torch.no_grad()
def _keep_tensor_slices(model: nn.Module, splits: Dict[str, TensorSplit],
                        rank: int, size: int) -> None:
    """Replace every tensor of `splits` by the rank's slice, in place (a
    matrix stored K-major, an int8 weight, models/llm/decoder.py
    `_k_major`, keeps that storage)."""
    mods = dict(model.named_modules())
    for key, split in splits.items():
        owner, _, name = key.rpartition(".")
        mod = mods[owner]
        store = mod._parameters if name in mod._parameters else mod._buffers
        t = store[name]
        if any(p % size for p in (split.parts or (t.shape[split.dim],))):
            raise ValueError(f"tensor={size} does not divide {key} "
                             f"{tuple(t.shape)} on dim {split.dim}")
        part = take_slice(t, split, rank, size)
        if (t.dim() >= 2 and not t.is_contiguous()
                and t.transpose(-1, -2).is_contiguous()):
            part = part.transpose(-1, -2).contiguous().transpose(-1, -2)
        else:
            part = part.contiguous().clone()
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
    if llm is not None and ctx.pipe_size > 1:
        from llavamod_tpu_torch.parallel.pipeline import keep_stage_layers

        keep_stage_layers(llm, ctx.pipe_size, ctx.pipe_rank)
    layers = list(llm.layers) if llm is not None else []
    for layer in layers:
        if getattr(layer, "is_moe", False):
            _keep_local_experts(layer.mlp.experts, ctx.expert_rank,
                                ctx.expert_size)
    splits: Dict[str, TensorSplit] = {}
    if llm is not None and ctx.tensor_size > 1:
        check_tensor_parallel(llm.cfg, ctx.tensor_size)
        splits = tensor_split(llm, llm.cfg)
        _keep_tensor_slices(model, splits, ctx.tensor_rank, ctx.tensor_size)
    model.tensor_split = splits
    names = {id(p): k for k, p in model.named_parameters()}
    specs = param_specs(model)

    def placement(param):
        key = names[id(param)]
        shape = list(param.shape)
        if ".experts." in key:
            shape[0] *= ctx.expert_size      # the rule is for all E experts
        if key in splits:
            shape[splits[key].dim] *= ctx.tensor_size
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


# ---------------------------------------------------------------------------
# LoRA adapters (models/lora.py) beside a sharded model
# ---------------------------------------------------------------------------

@torch.no_grad()
def shard_lora(lora: nn.Module, model: nn.Module, ctx) -> None:
    """Keep the rank's part of every adapter of `lora`, in place, for a
    model that `shard_params` sharded.  The port departs from the JAX rule
    table here (which places the `lora/...` leaves by their own paths, so
    that `up/a` [D, r] takes (fsdp, tensor)): the adapters stay plain
    tensors outside FSDP2, and

      * a and b follow their base's tensor split, so that each merge is the
        rank's slice of the whole merged weight: a column-parallel base
        [D, F / tensor] keeps b's [r, F / tensor] slice, a row-parallel one
        [F / tensor, D] a's [F / tensor, r] slice (recorded on
        `lora.tensor_split`, keyed as the adapters' state dict);
      * an expert adapter [E, ...] keeps the expert rank's E / expert
        experts;
      * everything else is whole on every rank of the rows group (the
        record's r = 128 FFN adapters are ~174 M entries), its gradient
        summed there (`reduce_adapter_grads`);
      * under pipe > 1 a stage keeps the adapters of its own layers only
        (`shard_params` kept those layers)."""
    from llavamod_tpu_torch.parallel.collectives import is_expert_key

    splits = getattr(model, "tensor_split", {})
    own: Dict[str, TensorSplit] = {}
    if ctx.pipe_size > 1:
        _keep_stage_adapters(lora, model)
    for key in lora.targets:
        pair = lora.get_submodule(key)
        if is_expert_key(key) and ctx.expert_size > 1:
            _keep_local_experts(pair, ctx.expert_rank, ctx.expert_size)
        split = splits.get(key)
        if split is None or ctx.tensor_size == 1:
            continue
        column = split.dim == pair.b.dim() - 1
        which, dim = ("b", pair.b.dim() - 1) if column else \
            ("a", pair.a.dim() - 2)
        t = getattr(pair, which)
        part = take_slice(t, TensorSplit(dim), ctx.tensor_rank,
                          ctx.tensor_size).contiguous().clone()
        pair._parameters[which] = nn.Parameter(part,
                                               requires_grad=t.requires_grad)
        own[f"{key}.{which}"] = TensorSplit(dim)
    lora.tensor_split = own


def _keep_stage_adapters(lora: nn.Module, model: nn.Module) -> None:
    """Drop, in place, the adapters whose target the stage's `model` does
    not hold."""
    params = {n for n, _ in model.named_parameters()}
    for key in [k for k in lora.targets if k not in params]:
        owner, _, leaf = key.rpartition(".")
        delattr(lora.get_submodule(owner), leaf)
    lora.targets = [k for k in lora.targets if k in params]


@torch.no_grad()
def reduce_adapter_grads(lora: nn.Module, grads: Dict[str, torch.Tensor],
                         pctx, prefix: str = "lora.") -> None:
    """Sum, in place, the adapters' gradients (`grads` keyed `prefix` +
    the adapters' state-dict keys) over the ranks whose rows reached them:
    first over tensor for the unsplit operand of a split merge (a rank's
    is its F slice's part of the product), then over the rows group, or
    for an expert adapter over data x fsdp (the ranks that hold the same
    experts)."""
    from llavamod_tpu_torch.parallel.collectives import is_expert_key

    dist = torch.distributed
    own = getattr(lora, "tensor_split", {})
    split_targets = {k.rpartition(".")[0] for k in own}
    for n, g in grads.items():
        if not n.startswith(prefix):
            continue
        key = n[len(prefix):]
        target = key.rpartition(".")[0]
        if pctx.tensor_size > 1 and target in split_targets \
                and key not in own:
            dist.all_reduce(g, group=pctx.tensor_group)
        if is_expert_key(key):
            for axis, size in (("data", pctx.cfg.data),
                               ("fsdp", pctx.fsdp_size)):
                if size > 1:
                    dist.all_reduce(
                        g, group=pctx.expert_param_mesh.get_group(axis))
        elif pctx.rows > 1:
            dist.all_reduce(g, group=pctx.rows_group)
