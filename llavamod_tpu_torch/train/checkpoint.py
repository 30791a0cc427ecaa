"""Checkpoint save/restore (port of llavamod_tpu/train/checkpoint.py).

  * the full training state under `output_dir/checkpoint-<step>/state.pt`
    through torch.save (the JAX package writes it with orbax): the model's
    state dict, the LoRA adapters' when the state has them, both optimizer
    groups with their moments and update counts, the MultiSteps
    accumulator and its position, and the step;
  * a run sharded over a mesh (parallel/sharding.py) writes
    `checkpoint-<step>/` with torch.distributed.checkpoint instead: every
    rank writes its shards of the model, of the optimizer moments, counts
    and MultiSteps state (the accumulator only mid-accumulation: it is zero
    at an update boundary) under its own `rank<r>.` keys, and `mesh.json`
    records the mesh; it restores onto the same mesh (a tensor rank's
    slices are its local tensors, saved under its own keys).
    `gather_full_state` assembles the whole model on rank 0 for the final
    save, which is the single-process format: FSDP2's shards, the experts
    of the expert ranks, the slices of the tensor ranks (a fused int8
    `wqkv` / `gate_up` put back block by block) and the layers of the
    pipeline stages; `gather_lora` the LoRA adapters alike.  Under pipe > 1
    a stage's ranks write its own layers under their global keys, so the
    sharded checkpoint holds every stage's layers;
  * auto-resume as the reference's train/train.py:527-530: when the output
    directory holds `checkpoint-*`, training restarts from the newest one;
  * the stage-1 `mm_projector.bin` in the reference's key layout: for
    `linear` and `mlp{N}x_gelu` the reference's nn.Sequential keys
    (`model.mm_projector.image_spatial_proj.<i>.{weight,bias}`, weights
    transposed to [out, in]), byte for byte what the JAX package writes;
    for the Q-Former the reference's Blip2Model keys (interop/hf.py); for
    the pool and simple projectors the `model.mm_projector.tree.<path>`
    flattening in the JAX tree's leaf order, read back against a template,
    with the simple projector's Python leaves (`same`, `heads`) written as
    the JAX package writes them, so the files interchange.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

STATE_NAME = "state.pt"
MESH_NAME = "mesh.json"
_TREE_PREFIX = "model.mm_projector.tree."
_SEQ_PREFIX = "model.mm_projector.image_spatial_proj."


def save_checkpoint(output_dir: str, step: int, state) -> str:
    """Write the whole TrainState under output_dir/checkpoint-<step>."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    saved = {"step": int(step), "model": state.model.state_dict(),
             "opt": state.opt.state_dict()}
    if state.lora is not None:
        saved["lora"] = state.lora.state_dict()
    torch.save(saved, os.path.join(path, STATE_NAME))
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(output_dir, name), int(m.group(1))
    return os.path.abspath(best) if best else None


@torch.no_grad()
def restore_checkpoint(path: str, state):
    """Load a checkpoint into `state` (its model and optimizer tensors are
    copied into, keeping their devices and dtypes); returns the state at
    the saved step."""
    saved = torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    if (state.lora is None) != ("lora" not in saved):
        raise ValueError(f"{path}: LoRA adapters in the checkpoint and in "
                         "the run differ")
    if state.lora is not None:
        state.lora.load_state_dict(saved["lora"], strict=True)
    state.opt.load_state_dict(saved["opt"])
    return state._replace(step=int(saved["step"]))


def maybe_auto_resume(output_dir: str, state, pctx=None
                      ) -> Tuple[object, Optional[str]]:
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, None
    if pctx is not None:
        return restore_sharded_checkpoint(path, state, pctx), path
    return restore_checkpoint(path, state), path


# ---------------------------------------------------------------------------
# sharded checkpoints (one process per card)
# ---------------------------------------------------------------------------

def _rank_state(state, accumulator: bool) -> dict:
    """This rank's part of the training state: the model's shards (and its
    buffers), the LoRA adapters' part (parallel/sharding.py `shard_lora`)
    and the optimizer's state (the fused step's Adafactor statistics, the
    factored rows and columns, are shards of the whole ones), all local
    tensors; the MultiSteps accumulator only with `accumulator` (it is
    zero at an update boundary)."""
    from llavamod_tpu_torch.parallel.sharding import local_tensor

    model = {k: local_tensor(v) for k, v in state.model.state_dict().items()}
    opt = state.opt.state_dict()
    if not accumulator:
        opt.pop("acc", None)
    out = {"model": model, "opt": opt}
    if state.lora is not None:
        out["lora"] = dict(state.lora.state_dict())
    return out


def _mesh_record(pctx) -> dict:
    import dataclasses

    return {"mesh": dataclasses.asdict(pctx.cfg), "world": pctx.world}


def save_sharded_checkpoint(output_dir: str, step: int, state, pctx) -> str:
    """Every rank writes its shards of the TrainState under
    output_dir/checkpoint-<step> (torch.distributed.checkpoint); rank 0
    also writes mesh.json."""
    import json

    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    acc = getattr(state.opt, "mini_step", 0) != 0
    if pctx.rank == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, MESH_NAME), "w") as f:
            json.dump(dict(_mesh_record(pctx), accumulator=acc), f)
    dcp.save({"step": int(step), f"rank{pctx.rank}": _rank_state(state, acc)},
             storage_writer=dcp.FileSystemWriter(
                 path, thread_count=min(8, os.cpu_count() or 1)))
    return path


@torch.no_grad()
def restore_sharded_checkpoint(path: str, state, pctx):
    """Load a sharded checkpoint in place into the rank's shards (the mesh
    must be the one it was written from); returns the state at its step."""
    import json

    import torch.distributed.checkpoint as dcp

    if not os.path.exists(os.path.join(path, MESH_NAME)):
        raise ValueError(f"{path} is not a sharded checkpoint (no "
                         f"{MESH_NAME}); it was written by one process")
    with open(os.path.join(path, MESH_NAME)) as f:
        saved = json.load(f)
    acc = saved.pop("accumulator")
    if saved != _mesh_record(pctx):
        raise ValueError(f"{path} was written on the mesh {saved}, not "
                         f"{_mesh_record(pctx)}")
    key = f"rank{pctx.rank}"
    sd = {"step": 0, key: _rank_state(state, acc)}
    dcp.load(sd, checkpoint_id=path)
    state.opt.load_state_dict(sd[key]["opt"])
    return state._replace(step=int(sd["step"]))


@torch.no_grad()
def gather_full_state(model, pctx) -> Optional[Dict[str, torch.Tensor]]:
    """The whole model's state dict on rank 0 (CPU tensors in their own
    dtypes, the keys of the unsharded model), None on the other ranks.
    Every rank takes part: each parameter is gathered over its shards, an
    expert tensor also over the expert ranks, and a tensor-split one
    (`model.tensor_split`, parallel/sharding.py) over the tensor ranks;
    under pipe > 1 each stage's first rank then hands its layers to rank 0
    (`_join_stages`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from llavamod_tpu_torch.parallel.collectives import is_expert_key
    from llavamod_tpu_torch.parallel.sharding import join_slices

    splits = getattr(model, "tensor_split", {})
    out = {}
    for k, v in model.state_dict().items():
        full = v.full_tensor() if isinstance(v, DTensor) else v
        if is_expert_key(k) and pctx.expert_size > 1:
            parts = [torch.empty_like(full) for _ in range(pctx.expert_size)]
            dist.all_gather(parts, full.contiguous(), group=pctx.expert_group)
            full = torch.cat(parts)
        if k in splits and pctx.tensor_size > 1:
            parts = [torch.empty_like(full) for _ in range(pctx.tensor_size)]
            dist.all_gather(parts, full.contiguous(), group=pctx.tensor_group)
            full = join_slices(parts, splits[k])
        if pctx.stage_rank == 0:
            out[k] = full.detach().cpu()
    return _join_stages(out, pctx)


def _join_stages(out: Dict[str, torch.Tensor], pctx
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """Under pipe > 1 the whole state dict on rank 0 from every stage's
    first rank's `out` (its own layers, whole): the stages' layer entries
    go to rank 0 over the pipe group, in the order of the layers, where
    stage 0's stood.  Returns `out` on rank 0, None elsewhere."""
    import torch.distributed as dist

    from llavamod_tpu_torch.parallel.pipeline import is_stage_key

    if pctx.pipe_size > 1 and pctx.stage_rank == 0:
        if pctx.pipe_rank > 0:
            own = {k: v for k, v in out.items() if is_stage_key(k)}
            dist.send_object_list(
                [[(k, tuple(v.shape), v.dtype) for k, v in own.items()]],
                dst=pctx.pipe_ranks[0], group=pctx.pipe_group)
            for v in own.values():
                pctx.send_stage(v, 0)
        else:
            joined = {k: v for k, v in out.items() if is_stage_key(k)}
            for stage in range(1, pctx.pipe_size):
                meta = [None]
                dist.recv_object_list(meta, src=pctx.pipe_ranks[stage],
                                      group=pctx.pipe_group)
                for k, shape, dtype in meta[0]:
                    joined[k] = pctx.recv_stage(shape, dtype, "cpu", stage)
            layers, done = sorted(joined, key=_layer_order), False
            ordered = {}
            for k, v in out.items():
                if not is_stage_key(k):
                    ordered[k] = v
                elif not done:
                    ordered.update((n, joined[n]) for n in layers)
                    done = True
            out = ordered
    return out if pctx.rank == 0 else None


def _layer_order(key: str):
    m = re.search(r"layers\.(\d+)\.", key)
    return int(m.group(1))


def stage_trainables(model, pctx) -> Optional[list]:
    """The keys of the trainable parameters of the whole model on rank 0:
    `model`'s, and under pipe > 1 every stage's (each stage holds its own
    layers only); every rank takes part."""
    import torch.distributed as dist

    keys = [n for n, p in model.named_parameters() if p.requires_grad]
    if pctx is None or pctx.pipe_size == 1:
        return keys
    parts = [None] * pctx.pipe_size
    dist.all_gather_object(parts, keys, group=pctx.pipe_group)
    seen = dict.fromkeys(k for part in parts for k in part)
    return list(seen)


@torch.no_grad()
def gather_lora(lora, pctx):
    """The whole LoRA adapters (models/lora.py `LoraAdapters`, host
    tensors) on rank 0, None on the other ranks.  Every rank takes part:
    an expert adapter is gathered over the expert ranks, a tensor-split
    one (`lora.tensor_split`) over the tensor ranks, and under pipe > 1
    the stages' adapters are joined on rank 0."""
    import torch.distributed as dist

    from llavamod_tpu_torch.models.lora import LoraAdapters
    from llavamod_tpu_torch.parallel.collectives import is_expert_key
    from llavamod_tpu_torch.parallel.sharding import join_slices

    splits = getattr(lora, "tensor_split", {})
    whole = {}
    for k, v in lora.state_dict().items():
        if is_expert_key(k) and pctx.expert_size > 1:
            parts = [torch.empty_like(v) for _ in range(pctx.expert_size)]
            dist.all_gather(parts, v.contiguous(), group=pctx.expert_group)
            v = torch.cat(parts)
        if k in splits and pctx.tensor_size > 1:
            parts = [torch.empty_like(v) for _ in range(pctx.tensor_size)]
            dist.all_gather(parts, v.contiguous(), group=pctx.tensor_group)
            v = join_slices(parts, splits[k])
        if pctx.stage_rank == 0:
            whole[k] = v.detach().cpu()
    whole = _join_stages(whole, pctx)
    if whole is None:
        return None
    targets = [k[:-len(".a")] for k in whole if k.endswith(".a")]
    return LoraAdapters({t: (whole[f"{t}.a"], whole[f"{t}.b"])
                         for t in targets})


# ---------------------------------------------------------------------------
# reference-compatible projector export/import (mm_projector.bin)
# ---------------------------------------------------------------------------

def _mlp_depth(projector_type: str) -> Optional[int]:
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    return int(m.group(1)) if m else None


def _is_qformer(projector_type: str) -> bool:
    return re.match(r"^(cheap_)?qformer\d+_\d+$", projector_type) is not None


def _tree_order(key: str):
    """The JAX tree_flatten order of a leaf: dict keys sorted, list
    entries by index."""
    return [(0, int(p), "") if p.isdigit() else (1, 0, p)
            for p in key.split(".")]


def mm_projector_state(projector: Dict[str, torch.Tensor],
                       projector_type: str = "mlp2x_gelu"
                       ) -> Dict[str, torch.Tensor]:
    """The entries of an mm_projector.bin from the projector's state dict
    (keys as `Llava.projector.state_dict()`: 'kernel'/'bias' for linear,
    'layers.<j>.kernel'/'.bias' for the MLP), CPU tensors in their own
    dtype."""
    t = {k: v.detach().cpu() for k, v in projector.items()}
    depth = _mlp_depth(projector_type)
    if _is_qformer(projector_type):
        from llavamod_tpu_torch.interop.hf import projector_params_to_hf

        return {k: v.contiguous() for k, v in
                projector_params_to_hf(t, projector_type).items()}
    if projector_type == "linear":
        return {_SEQ_PREFIX + "weight": t["kernel"].t().contiguous(),
                _SEQ_PREFIX + "bias": t["bias"].clone()}
    if depth is not None:
        state = {}
        for j in range(depth):
            idx = j * 2  # nn.Sequential: Linear, GELU, Linear, ...
            state[f"{_SEQ_PREFIX}{idx}.weight"] = \
                t[f"layers.{j}.kernel"].t().contiguous()
            state[f"{_SEQ_PREFIX}{idx}.bias"] = t[f"layers.{j}.bias"].clone()
        return state
    from llavamod_tpu_torch.models.qformer import tree_scalars

    t.update(tree_scalars(projector_type, t))
    return {_TREE_PREFIX + k: t[k].clone() for k in sorted(t, key=_tree_order)}


def save_mm_projector(path: str, projector: Dict[str, torch.Tensor],
                      projector_type: str = "mlp2x_gelu") -> str:
    """Write an mm_projector.bin from the projector's state dict
    (`mm_projector_state`)."""
    state = mm_projector_state(projector, projector_type)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)
    return path


def load_mm_projector(path: str, projector_type: str = "mlp2x_gelu",
                      template: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Read an mm_projector.bin into the projector's state-dict keys (load
    it with `model.projector.load_state_dict`).  The tree layout needs
    `template`, the projector's current state dict, for its keys and
    shapes (the Python leaves of the simple projector's entries are module
    config here and are not read)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return mm_projector_from_state(state, projector_type, template, path)


def mm_projector_from_state(state: Dict[str, torch.Tensor],
                            projector_type: str = "mlp2x_gelu",
                            template: Optional[Dict[str, torch.Tensor]] = None,
                            source: str = "mm_projector.bin"
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of `mm_projector_state`."""
    if not any(k.startswith(_TREE_PREFIX) for k in state):
        from llavamod_tpu_torch.interop.hf import projector_params_from_hf

        return projector_params_from_hf(state, projector_type)
    if template is None:
        raise ValueError(f"{source} for '{projector_type}' uses the tree "
                         "layout; pass template= (the projector's state "
                         "dict)")
    out = {}
    for k, leaf in template.items():
        t = state[_TREE_PREFIX + k]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(t.shape)} vs "
                             f"template {tuple(leaf.shape)}")
        out[k] = t
    return out
