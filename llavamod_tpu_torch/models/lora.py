"""LoRA adapters as a module of their own (port of llavamod_tpu/models/lora.py).

The reference trains PEFT LoRA (train/train.py:300-331, align_train.py:
290-327) and merges the adapters into plain weights for export
(scripts/merge_lora_weights.py, scripts/merge_moe_lora_weights.py:31-85).
The JAX package keeps the adapters as a tree beside the base params and
runs the unchanged model on `merge_lora(base, lora)` each step.  Here the
adapters are a `LoraAdapters` module beside the unchanged model: its
state-dict keys are each target's key plus '.a' / '.b'
('llm.layers.2.mlp.experts.up.a', [E, D, r] for stacked experts), the JAX
tree's paths.  `lora_merged` puts the effective weights

    base + scaling * (a @ b).to(base.dtype),    scaling = alpha / r

in the targets' places for a block that holds the forward and the backward
(a rematerialised layer recomputes with them in the backward, which is why
this is a context and not one `torch.func.functional_call`, whose swap ends
with the forward); the module's parameters and their keys stay as they are
(`torch.nn.utils.parametrize` would rename them).  No dropout is applied:
the JAX package keeps `dropout` in the config and never uses it.  The init
draws a ~ N(0, 1) / r and b = 0, so a fresh adapter changes nothing.

Adapter files are PEFT's: adapter_config.json + adapter_model.bin with
'base_model.model.model.layers.{i}.mlp.up_proj.lora_A.weight' keys (A
[r, in], B [out, r], f32), stacked experts per expert under DeepSpeed-MoE
names ('...mlp.deepspeed_moe.experts.deepspeed_experts.{e}.up_proj...').
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from llavamod_tpu_torch.models.params import ParamGroup

# llm linear weights eligible for LoRA; mirrors find_all_linear_names
# (train/train_utils.py:64-79), which excludes projector, tower and lm_head
DEFAULT_TARGETS = (
    r"llm/layers/\d+/attn/(wq|wk|wv|wo)$",
    r"llm/layers/\d+/mlp/(gate|up|down)$",
    r"llm/layers/\d+/mlp/experts/(gate|up|down)$",
)
# --only_lora_ffn (the trainer's default; JAX train/run.py:186-189)
FFN_TARGETS = DEFAULT_TARGETS[1:]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    dropout: float = 0.0   # kept for the file; never applied
    target_patterns: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def is_target(key: str, cfg: LoraConfig) -> bool:
    """`key` a state-dict key ('llm.layers.0.mlp.up')."""
    path = key.replace(".", "/")
    return any(re.search(pat, path) for pat in cfg.target_patterns)


class LoraAdapters(nn.Module):
    """{target key: ParamGroup(a, b)}, nested so that the state-dict keys are
    the targets' keys plus '.a' / '.b'.  `targets` lists the target keys."""

    def __init__(self, pairs: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.targets = list(pairs)
        for key, (a, b) in pairs.items():
            *parents, leaf = key.split(".")
            node = self
            for name in parents:
                if name not in node._modules:
                    node.add_module(name, nn.Module())
                node = node._modules[name]
            node.add_module(leaf, ParamGroup(a=a, b=b))

    def pair(self, key: str) -> ParamGroup:
        return self.get_submodule(key)


def init_lora(model: nn.Module, cfg: LoraConfig,
              generator: torch.Generator) -> LoraAdapters:
    """Adapters for every target parameter of rank 2 or 3 (experts [E, in,
    out] get per-expert adapters), in the parameter's dtype and device."""
    pairs = {}
    for key, w in model.named_parameters():
        if not is_target(key, cfg) or w.dim() < 2:
            continue
        *lead, din, dout = w.shape
        a = torch.randn((*lead, din, cfg.r), generator=generator,
                        device=w.device, dtype=torch.float32) / cfg.r
        b = torch.zeros((*lead, cfg.r, dout), device=w.device)
        pairs[key] = (a.to(w.dtype), b.to(w.dtype))
    return LoraAdapters(pairs)


def merged_weight(base: torch.Tensor, pair: ParamGroup,
                  cfg: LoraConfig) -> torch.Tensor:
    """base + scaling * a @ b (batched over a leading expert axis)."""
    delta = torch.matmul(pair.a, pair.b)
    return base + cfg.scaling * delta.to(base.dtype)


@contextlib.contextmanager
def lora_merged(model: nn.Module, lora: Optional[LoraAdapters],
                cfg: Optional[LoraConfig]):
    """Within the block, each target of `model` reads as its merged weight
    (a differentiable function of the adapters); a no-op without adapters.
    The forward and the backward both run inside the block.  On a model
    that FSDP2 sharded (parallel/sharding.py) a unit registers its
    gathered parameters on each call, which would drop a swap made
    before it: there the merge runs in a forward pre-hook of the unit
    that owns the target, after FSDP2's gather, on every call (the
    recompute of a rematerialised layer included), and a forward hook
    puts the gathered weight back before FSDP2 reshards."""
    if lora is None:
        yield model
        return
    from llavamod_tpu_torch.parallel.sharding import is_sharded

    if is_sharded(model):
        with _merged_per_unit(model, lora, cfg):
            yield model
        return
    saved = []
    for key in lora.targets:
        mod_name, _, name = key.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved.append((mod, name, mod._parameters[name]))
        mod._parameters[name] = merged_weight(mod._parameters[name],
                                              lora.pair(key), cfg)
    try:
        yield model
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def _owning_unit(model: nn.Module, key: str) -> str:
    """The name of the innermost FSDP2 unit that holds parameter `key`."""
    from llavamod_tpu_torch.parallel.sharding import is_sharded

    parts = key.split(".")[:-1]
    for i in range(len(parts), 0, -1):
        name = ".".join(parts[:i])
        if is_sharded(model.get_submodule(name)):
            return name
    return ""


@contextlib.contextmanager
def _merged_per_unit(model: nn.Module, lora: LoraAdapters, cfg: LoraConfig):
    """The hooks of `lora_merged` on a sharded model.  A recompute that
    torch.utils.checkpoint stops early (once it has every tensor the
    backward needs) never reaches the forward hook: its merged weights stay
    in place until FSDP2's post-backward reshard registers the sharded
    parameters again, and the next call of the unit starts afresh."""
    by_unit: Dict[str, list] = {}
    for key in lora.targets:
        by_unit.setdefault(_owning_unit(model, key), []).append(key)
    handles, pending = [], {}
    for unit_name, keys in by_unit.items():
        unit = model.get_submodule(unit_name) if unit_name else model
        targets = [(model.get_submodule(k.rpartition(".")[0]),
                    k.rpartition(".")[2], lora.pair(k)) for k in keys]

        def merge(module, args, targets=targets, unit_name=unit_name):
            swapped = []
            for mod, name, pair in targets:
                base = mod._parameters[name]
                mod._parameters[name] = merged_weight(base, pair, cfg)
                swapped.append((mod, name, base, mod._parameters[name]))
            pending[unit_name] = swapped

        def restore(module, args, output, unit_name=unit_name):
            for mod, name, base, _ in pending.pop(unit_name, ()):
                mod._parameters[name] = base

        handles.append(unit.register_forward_pre_hook(merge))
        handles.append(unit.register_forward_hook(restore, prepend=True))
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
        # a call that raised: put back the weights it merged, where FSDP2
        # has not registered its own since
        for swapped in pending.values():
            for mod, name, base, merged in swapped:
                if mod._parameters[name] is merged:
                    mod._parameters[name] = base


@torch.no_grad()
def merge_lora_(model: nn.Module, lora: LoraAdapters,
                cfg: LoraConfig) -> nn.Module:
    """Write the merged weights into `model` in place (the export)."""
    weights = dict(model.named_parameters())
    for key in lora.targets:
        w = weights[key]
        w.copy_(merged_weight(w, lora.pair(key), cfg))
    return model


@torch.no_grad()
def merge_lora_state_(state: Dict[str, torch.Tensor], lora: LoraAdapters,
                      cfg: LoraConfig, device=None) -> Dict[str, torch.Tensor]:
    """`merge_lora_` on a state dict of host tensors (the whole model and
    adapters a sharded run gathers on rank 0), in place: each target's
    merged weight is computed on `device`, where the run's weights live,
    so that it has the bits a single process's `merge_lora_` gives."""
    for key in lora.targets:
        w = state[key]
        pair = lora.pair(key)
        delta = torch.matmul(pair.a.to(device), pair.b.to(device))
        state[key] = (w.to(device) + cfg.scaling * delta.to(w.dtype)).to(
            w.device)
    return state


# ---------------------------------------------------------------------------
# adapter checkpoints in PEFT's layout
# ---------------------------------------------------------------------------

# our path suffix -> HF module name (reference PEFT target naming)
_HF_MODULE_NAMES = {
    "attn/wq": "self_attn.q_proj",
    "attn/wk": "self_attn.k_proj",
    "attn/wv": "self_attn.v_proj",
    "attn/wo": "self_attn.o_proj",
    "mlp/gate": "mlp.gate_proj",
    "mlp/up": "mlp.up_proj",
    "mlp/down": "mlp.down_proj",
}
_OUR_SUFFIXES = {v: k for k, v in _HF_MODULE_NAMES.items()}


def _peft_key(key: str, expert: Optional[int] = None) -> Optional[str]:
    """'llm.layers.3.mlp.up' -> 'base_model.model.model.layers.3.mlp.up_proj';
    expert adapters per expert under DeepSpeed-MoE naming."""
    path = key.replace(".", "/")
    m = re.match(r"^llm/layers/(\d+)/(attn/w[qkvo]|mlp/(?:gate|up|down))$",
                 path)
    if m:
        hf = _HF_MODULE_NAMES[m.group(2)]
        return f"base_model.model.model.layers.{m.group(1)}.{hf}"
    m = re.match(r"^llm/layers/(\d+)/mlp/experts/(gate|up|down)$", path)
    if m and expert is not None:
        mod = _HF_MODULE_NAMES["mlp/" + m.group(2)].split(".")[-1]
        return (f"base_model.model.model.layers.{m.group(1)}"
                f".mlp.deepspeed_moe.experts.deepspeed_experts.{expert}.{mod}")
    return None


def save_lora_adapter(output_dir: str, lora: LoraAdapters,
                      cfg: LoraConfig) -> str:
    """Write a PEFT adapter directory (train/train.py:535-545 layout)."""
    os.makedirs(output_dir, exist_ok=True)
    state: Dict[str, torch.Tensor] = {}
    for key in lora.targets:
        pair = lora.pair(key)
        for which, t in (("lora_A", pair.a), ("lora_B", pair.b)):
            t = t.detach().to("cpu", torch.float32)
            if t.dim() == 3:     # experts [E, ...]
                for e in range(t.shape[0]):
                    state[f"{_peft_key(key, e)}.{which}.weight"] = \
                        t[e].t().contiguous()
            elif _peft_key(key) is not None:
                # ours: a [in, r] / b [r, out]; PEFT: A [r, in] / B [out, r]
                state[f"{_peft_key(key)}.{which}.weight"] = t.t().contiguous()
    torch.save(state, os.path.join(output_dir, "adapter_model.bin"))
    with open(os.path.join(output_dir, "adapter_config.json"), "w") as fh:
        json.dump({"peft_type": "LORA", "r": cfg.r, "lora_alpha": cfg.alpha,
                   "lora_dropout": cfg.dropout,
                   "target_modules": sorted({v.split(".")[-1] for v in
                                             _HF_MODULE_NAMES.values()}),
                   "bias": "none", "task_type": "CAUSAL_LM"}, fh, indent=2)
    return output_dir


def _parse_peft_key(key: str):
    """PEFT key -> (our state-dict key, 'a' | 'b', expert index or None)."""
    key = re.sub(r"^base_model\.(model\.)+", "", key)
    which = "a" if ".lora_A." in key else ("b" if ".lora_B." in key else None)
    if which is None:
        return None
    mod = re.sub(r"^model\.", "", key.split(".lora_")[0])
    m = re.match(r"^layers\.(\d+)\.mlp\.deepspeed_moe\.experts"
                 r"\.deepspeed_experts\.(\d+)\.(\w+)$", mod)
    if m:
        suffix = _OUR_SUFFIXES.get("mlp." + m.group(3))
        if suffix is None:
            return None
        path = f"llm/layers/{m.group(1)}/" + suffix.replace("mlp/",
                                                            "mlp/experts/")
        return path.replace("/", "."), which, int(m.group(2))
    m = re.match(r"^layers\.(\d+)\.(self_attn\.\w+|mlp\.\w+)$", mod)
    if m and m.group(2) in _OUR_SUFFIXES:
        path = f"llm/layers/{m.group(1)}/{_OUR_SUFFIXES[m.group(2)]}"
        return path.replace("/", "."), which, None
    return None


def lora_tree_from_peft(state: Dict[str, torch.Tensor], model: nn.Module,
                        cfg: LoraConfig) -> LoraAdapters:
    """Adapters (f32, on the model's device) from PEFT tensors, for the
    targets `model` has; expert adapters stack on the leading E axis."""
    by_key: Dict[str, Dict[str, object]] = {}
    for k, v in state.items():
        parsed = _parse_peft_key(k)
        if parsed is None:
            continue
        key, which, expert = parsed
        slot = by_key.setdefault(key, {})
        t = v.float().t()    # PEFT A [r, in] -> ours a [in, r]; B likewise
        if expert is None:
            slot[which] = t
        else:
            slot.setdefault(which, {})[expert] = t
    weights = dict(model.named_parameters())
    pairs = {}
    for key, w in weights.items():
        entry = by_key.get(key)
        if entry is None or "a" not in entry or "b" not in entry:
            continue
        a, b = entry["a"], entry["b"]
        if isinstance(a, dict):
            a = torch.stack([a[i] for i in range(w.shape[0])])
            b = torch.stack([b[i] for i in range(w.shape[0])])
        pairs[key] = (a.contiguous().to(w.device),
                      b.contiguous().to(w.device))
    return LoraAdapters(pairs)


def load_lora_adapter(adapter_dir: str, model: nn.Module
                      ) -> Tuple[LoraAdapters, LoraConfig]:
    """Read a PEFT adapter directory against `model`'s targets."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as fh:
        pc = json.load(fh)
    cfg = LoraConfig(r=pc["r"], alpha=pc["lora_alpha"],
                     dropout=pc.get("lora_dropout", 0.0))
    state = torch.load(os.path.join(adapter_dir, "adapter_model.bin"),
                       map_location="cpu", weights_only=True)
    return lora_tree_from_peft(state, model, cfg), cfg


# ---------------------------------------------------------------------------
# non_lora_trainables.bin: the run's trained tensors that are not adapters
# ---------------------------------------------------------------------------

NON_LORA_FILE = "non_lora_trainables.bin"
_PEFT_PREFIX = "base_model.model."


class _Partial(Mapping):
    """A state dict whose entries outside `keep` read as meta tensors of
    their shape and dtype: the HF converters of interop/hf.py turn it into
    the kept entries' HF tensors beside meta stand-ins for the rest."""

    def __init__(self, state: Dict[str, torch.Tensor], keep):
        self.state, self.keep = state, set(keep)

    def __getitem__(self, key: str) -> torch.Tensor:
        v = self.state[key]
        if key in self.keep:
            return v
        return torch.empty(v.shape, dtype=v.dtype, device="meta")

    def __iter__(self):
        return iter(self.state)

    def __len__(self) -> int:
        return len(self.state)


def save_non_lora_trainables(adapter_dir: str, model: nn.Module,
                             full: Optional[Dict[str, torch.Tensor]] = None,
                             trainable: Optional[List[str]] = None) -> str:
    """Write `adapter_dir/non_lora_trainables.bin`: every trainable
    parameter of `model` (requires_grad, which excludes the adapted
    targets) in the reference's layout (train.py:535-545): PEFT's
    'base_model.model.' before the HF names, the router as
    '...mlp.deepspeed_moe.gate.wg.weight' (interop/hf.py), the projector as
    in mm_projector.bin; any other module under its own state-dict key.
    Tensors keep their dtype.  `full`: the model's whole state dict, read
    in place of `model`'s own tensors (a sharded model's, gathered), and
    `trainable` the keys of the trainable parameters of the whole model
    (a pipeline stage holds its own layers only; default: `model`'s)."""
    from llavamod_tpu_torch.interop.hf import decoder_params_to_hf
    from llavamod_tpu_torch.train.checkpoint import mm_projector_state

    cfg = model.cfg
    if trainable is None:
        trainable = [n for n, p in model.named_parameters()
                     if p.requires_grad]
    if full is None:
        full = model.state_dict()

    def part(prefix):
        return {k[len(prefix):]: v for k, v in full.items()
                if k.startswith(prefix)}

    state: Dict[str, torch.Tensor] = {}
    llm_keep = [k[len("llm."):] for k in trainable if k.startswith("llm.")]
    if llm_keep:
        hf = decoder_params_to_hf(_Partial(part("llm."), llm_keep), cfg.llm)
        state.update({_PEFT_PREFIX + k: v for k, v in hf.items()
                      if v.device.type != "meta"})
    if any(k.startswith("projector.") for k in trainable):
        state.update({_PEFT_PREFIX + k: v for k, v in mm_projector_state(
            part("projector."), cfg.projector_type).items()})
    for k in trainable:
        if not k.startswith(("llm.", "projector.")):
            state[_PEFT_PREFIX + k] = full[k]
    state = {k: v.detach().to("cpu").contiguous() for k, v in state.items()}
    os.makedirs(adapter_dir, exist_ok=True)
    path = os.path.join(adapter_dir, NON_LORA_FILE)
    torch.save(state, path)
    return path


@torch.no_grad()
def load_non_lora_trainables(path: str, model: nn.Module) -> None:
    """Copy every tensor of a non_lora_trainables.bin into `model` (its
    dtype and device kept).  The PEFT wrapper's prefixes are stripped
    first, as the reference does."""
    from llavamod_tpu_torch.interop.hf import (
        decoder_params_from_hf,
        decoder_params_to_hf,
    )
    from llavamod_tpu_torch.train.checkpoint import mm_projector_from_state

    cfg = model.cfg
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {re.sub(r"^(base_model\.)?(model\.)?", "", k): v
             for k, v in state.items()}
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    proj = {k: v for k, v in state.items() if "mm_projector" in k}
    if proj:
        template = model.projector.state_dict()
        out.update({"projector." + k: v for k, v in mm_projector_from_state(
            proj, cfg.projector_type, template, path).items()})
    own = {k: v for k, v in state.items() if k in params}
    out.update(own)
    llm = {k: v for k, v in state.items() if k not in proj and k not in own}
    if llm:
        names = decoder_params_to_hf(_Partial(model.llm.state_dict(), ()),
                                     cfg.llm)
        unknown = sorted(set(llm) - set(names))
        if unknown:
            raise ValueError(f"{path}: entries that are no tensor of the "
                             f"model: {unknown[:4]}")
        ours = decoder_params_from_hf({**names, **llm}, cfg.llm)
        out.update({"llm." + k: v for k, v in ours.items()
                    if v.device.type != "meta"})
    for k, v in out.items():
        params[k].copy_(v)


def merge_lora_checkpoint(adapter_path: str, cfg, model: nn.Module):
    """The reference's LoRA-checkpoint load (model/builder.py:82-155):
    `model` is the BASE model (`cfg` its config); the adapter is merged into
    it in place, and every tensor of `non_lora_trainables.bin` (the router
    and the projector a LoRA run trains) replaces the base's when the
    adapter directory has one.  Returns (cfg, model).  (The JAX function
    also takes the base's path, and never reads it; it reads only the
    projector out of the file.)"""
    lora, lcfg = load_lora_adapter(adapter_path, model)
    merge_lora_(model, lora, lcfg)
    extra = os.path.join(adapter_path, NON_LORA_FILE)
    if os.path.exists(extra):
        load_non_lora_trainables(extra, model)
    return cfg, model
