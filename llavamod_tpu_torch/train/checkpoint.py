"""Checkpoint save/restore (port of llavamod_tpu/train/checkpoint.py).

  * the full training state under `output_dir/checkpoint-<step>/state.pt`
    through torch.save (the JAX package writes it with orbax): the model's
    state dict, both AdamW groups with their moments and update counts, the
    MultiSteps accumulator and its position, and the step;
  * auto-resume as the reference's train/train.py:527-530: when the output
    directory holds `checkpoint-*`, training restarts from the newest one;
  * the stage-1 `mm_projector.bin` in the reference's key layout: for
    `linear` and `mlp{N}x_gelu` the reference's nn.Sequential keys
    (`model.mm_projector.image_spatial_proj.<i>.{weight,bias}`, weights
    transposed to [out, in]), byte for byte what the JAX package writes;
    for the other ported projectors the `model.mm_projector.tree.<path>`
    flattening, read back against a template.  Q-Former layouts come with
    the Q-Former port (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

STATE_NAME = "state.pt"
_TREE_PREFIX = "model.mm_projector.tree."
_SEQ_PREFIX = "model.mm_projector.image_spatial_proj."


def save_checkpoint(output_dir: str, step: int, state) -> str:
    """Write the whole TrainState under output_dir/checkpoint-<step>."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save({"step": int(step),
                "model": state.model.state_dict(),
                "opt": state.opt.state_dict()},
               os.path.join(path, STATE_NAME))
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
    state.opt.load_state_dict(saved["opt"])
    return state._replace(step=int(saved["step"]))


def maybe_auto_resume(output_dir: str, state) -> Tuple[object, Optional[str]]:
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, None
    return restore_checkpoint(path, state), path


# ---------------------------------------------------------------------------
# reference-compatible projector export/import (mm_projector.bin)
# ---------------------------------------------------------------------------

def _mlp_depth(projector_type: str) -> Optional[int]:
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    return int(m.group(1)) if m else None


def _check_ported(projector_type: str) -> None:
    if re.match(r"^(cheap_)?qformer\d+_\d+$", projector_type):
        raise NotImplementedError(
            f"mm_projector.bin for '{projector_type}' (Q-Former keys) is not "
            f"ported yet (ROADMAP Queue 1, item 6)")


def save_mm_projector(path: str, projector: Dict[str, torch.Tensor],
                      projector_type: str = "mlp2x_gelu") -> str:
    """Write an mm_projector.bin from the projector's state dict (keys as
    `Llava.projector.state_dict()`: 'kernel'/'bias' for linear,
    'layers.<j>.kernel'/'.bias' for the MLP), tensors in their own dtype."""
    _check_ported(projector_type)
    t = {k: v.detach().cpu() for k, v in projector.items()}
    depth = _mlp_depth(projector_type)
    if projector_type == "linear":
        state = {_SEQ_PREFIX + "weight": t["kernel"].t().contiguous(),
                 _SEQ_PREFIX + "bias": t["bias"].clone()}
    elif depth is not None:
        state = {}
        for j in range(depth):
            idx = j * 2  # nn.Sequential: Linear, GELU, Linear, ...
            state[f"{_SEQ_PREFIX}{idx}.weight"] = \
                t[f"layers.{j}.kernel"].t().contiguous()
            state[f"{_SEQ_PREFIX}{idx}.bias"] = t[f"layers.{j}.bias"].clone()
    else:
        state = {_TREE_PREFIX + k: v.clone() for k, v in t.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)
    return path


def projector_state_from_hf(state: Dict[str, torch.Tensor],
                            projector_type: str) -> Dict[str, torch.Tensor]:
    """The port's copy of the linear / mlp branch of the JAX package's
    interop/hf.py::projector_params_from_hf: reference mm_projector keys
    ('model.mm_projector.image_spatial_proj.0.weight', [out, in]) -> the
    projector's state-dict keys ([in, out] kernels)."""
    cleaned = {}
    for k, v in state.items():
        k = k.replace("model.mm_projector.", "").replace("mm_projector.", "")
        cleaned[k.replace("image_spatial_proj.", "")] = v
    if projector_type == "linear":
        return {"kernel": cleaned["weight"].t().contiguous(),
                "bias": cleaned["bias"]}
    depth = _mlp_depth(projector_type)
    if depth is None:
        raise NotImplementedError(
            f"mm_projector.bin import for '{projector_type}' is not ported "
            f"yet (ROADMAP Queue 1, item 6)")
    out = {}
    for j in range(depth):
        idx = j * 2  # reference nn.Sequential indices: 0, 2, 4 ... (GELU between)
        out[f"layers.{j}.kernel"] = cleaned[f"{idx}.weight"].t().contiguous()
        out[f"layers.{j}.bias"] = cleaned[f"{idx}.bias"]
    return out


def load_mm_projector(path: str, projector_type: str = "mlp2x_gelu",
                      template: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Read an mm_projector.bin into the projector's state-dict keys (load
    it with `model.projector.load_state_dict`).  The tree layout needs
    `template`, the projector's current state dict, for its keys and
    shapes."""
    _check_ported(projector_type)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not any(k.startswith(_TREE_PREFIX) for k in state):
        return projector_state_from_hf(state, projector_type)
    if template is None:
        raise ValueError(f"mm_projector.bin for '{projector_type}' uses the "
                         "tree layout; pass template= (the projector's "
                         "state dict)")
    out = {}
    for k, leaf in template.items():
        t = state[_TREE_PREFIX + k]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(t.shape)} vs "
                             f"template {tuple(leaf.shape)}")
        out[k] = t
    return out
