"""Trainable sets, learning-rate schedules and AdamW (port of
llavamod_tpu/train/optim.py).

The JAX package decides per leaf of the param tree, by its '/'-joined path,
whether the leaf trains; frozen leaves are stop-gradient'd and get zero
updates.  Here the same rule runs on the '/'-joined form of each state_dict
key, and a frozen parameter gets `requires_grad=False`, so autograd forms no
gradient for it and the optimizer holds no state for it.

AdamW follows optax.adamw chained after optax.clip_by_global_norm, as
`build_optimizer` chains them: moments kept in the parameter's dtype (as
optax keeps them), arithmetic in f32, weight decay on tensors of rank >= 2,
the schedule evaluated at the update count starting from 0 (so warmup gives
lr = 0 on the first update), a separate schedule for the projector when
`mm_projector_lr` is set.  Parameters are updated in place.

Gradient accumulation follows optax.MultiSteps (`MultiSteps`): a running
mean of the microbatch gradients, the inner update (clip, then AdamW per
label) on every k-th call only, so the schedule advances once per optimizer
step.  Adafactor is not ported yet (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

from llavamod_tpu_torch.train.config import TrainConfig


def _path(name: str) -> str:
    """state_dict key -> the JAX param-tree path ('llm.layers.0.mlp.up' ->
    'llm/layers/0/mlp/up')."""
    return name.replace(".", "/")


def _is_projector(p: str) -> bool:
    return p.startswith("projector") or p.startswith("video_projector")


def trainable_mask(model: nn.Module, cfg: TrainConfig,
                   lora_cfg=None) -> Dict[str, bool]:
    """{state_dict key: True where the parameter receives updates}: the
    vision tower never trains; stage 1 (tune_mm_mlp_adapter) trains only the
    projector; otherwise `train_modules` substrings (plus the projector
    unless frozen) select the set, and an empty set trains everything."""
    if lora_cfg is not None:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP Queue 1)")

    def decide(p: str) -> bool:
        if p.startswith("vision"):
            return False
        if cfg.tune_mm_mlp_adapter:
            return _is_projector(p)
        if _is_projector(p) and cfg.freeze_mm_mlp_adapter:
            return False
        if cfg.train_modules:
            return _is_projector(p) or any(m in p for m in cfg.train_modules)
        return True

    return {n: decide(_path(n)) for n, _ in model.named_parameters()}


def param_labels(model: nn.Module, cfg: TrainConfig) -> Dict[str, str]:
    """{key: 'frozen' | 'projector' | 'default'} (the multi_transform
    labels)."""
    mask = trainable_mask(model, cfg)

    def label(n: str) -> str:
        if not mask[n]:
            return "frozen"
        if _is_projector(_path(n)) and cfg.mm_projector_lr:
            return "projector"
        return "default"

    return {n: label(n) for n in mask}


def apply_trainable_mask(model: nn.Module, cfg: TrainConfig) -> Dict[str, bool]:
    """Set requires_grad from `trainable_mask`; returns the mask."""
    mask = trainable_mask(model, cfg)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    return mask


def make_lr_schedule(cfg: TrainConfig, base_lr: float) -> Callable[[int], float]:
    """count -> learning rate, as the optax schedules of the JAX package."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 0)
    total = cfg.total_steps

    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def cosine(count):
        decay = total - warmup
        c = min(count, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    if cfg.lr_schedule == "cosine":
        return lambda c: (linear(0.0, base_lr, warmup, c) if c < warmup
                          else cosine(c - warmup))
    if cfg.lr_schedule == "linear":
        return lambda c: (linear(0.0, base_lr, warmup, c) if c < warmup
                          else linear(base_lr, 0.0, total - warmup,
                                      c - warmup))
    return lambda c: base_lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, in f32."""
    sq = [g.float().pow(2).sum() for g in grads if g is not None]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


class AdamW:
    """optax.adamw over one label group of parameters."""

    def __init__(self, params: Dict[str, nn.Parameter], cfg: TrainConfig,
                 lr: float):
        self.params = params
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, lr)
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.adam_b1 ** self.count
        bc2 = 1.0 - cfg.adam_b2 ** self.count
        for n, p in self.params.items():
            g = grads[n].float()
            mu = (1 - cfg.adam_b1) * g + cfg.adam_b1 * self.mu[n].float()
            nu = (1 - cfg.adam_b2) * g * g + cfg.adam_b2 * self.nu[n].float()
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            if cfg.weight_decay and p.dim() >= 2:
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() + (-lr) * upd)
            self.mu[n].copy_(mu)
            self.nu[n].copy_(nu)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        _copy_into(self.mu, state["mu"])
        _copy_into(self.nu, state["nu"])
        self.count = int(state["count"])


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    if dst.keys() != src.keys():
        raise ValueError(f"state keys differ: {sorted(dst.keys() ^ src.keys())[:4]}")
    for n, t in dst.items():
        t.copy_(src[n])


class Optimizer:
    """clip_by_global_norm, then AdamW per label; frozen parameters are
    left as they are (optax.set_to_zero)."""

    def __init__(self, model: nn.Module, cfg: TrainConfig):
        if cfg.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r} is not ported yet (Adafactor: "
                f"ROADMAP Queue 1, item 4)")
        self.cfg = cfg
        labels = param_labels(model, cfg)
        named = dict(model.named_parameters())
        lrs = {"default": cfg.learning_rate,
               "projector": cfg.mm_projector_lr or cfg.learning_rate}
        self.groups = {
            lab: AdamW({n: named[n] for n, lb in labels.items() if lb == lab},
                       cfg, lr)
            for lab, lr in lrs.items()}

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return {n: p for g in self.groups.values() for n, p in g.params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update from {key: gradient} of every trainable parameter.
        The gradients are clipped in place; returns their global norm
        before clipping."""
        norm = global_norm(grads.values())
        if self.cfg.max_grad_norm and norm >= self.cfg.max_grad_norm:
            for g in grads.values():
                g.div_(norm.to(g.dtype)).mul_(self.cfg.max_grad_norm)
        for group in self.groups.values():
            group.update(grads)
        return norm

    @property
    def updates(self) -> int:
        """Optimizer updates applied so far."""
        return next(iter(self.groups.values())).count

    def state_dict(self) -> dict:
        return {lab: g.state_dict() for lab, g in self.groups.items()}

    def load_state_dict(self, state: dict) -> None:
        for lab, g in self.groups.items():
            g.load_state_dict(state[lab])


class MultiSteps:
    """optax.MultiSteps(Optimizer, k): every call folds the microbatch
    gradients into a running mean, (g + n * acc) / (n + 1), kept in the
    gradient's dtype; the k-th call hands the mean to the inner optimizer
    (clip, then AdamW) and starts a new mean."""

    def __init__(self, inner: Optimizer, k: int):
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in inner.params.items()}

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return self.inner.params

    @property
    def updates(self) -> int:
        return self.inner.updates

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Accumulates {key: gradient}; returns the global norm of these
        (microbatch) gradients, not of the mean."""
        norm = global_norm(grads.values())
        n = self.mini_step
        for name, acc in self.acc.items():
            acc.copy_((grads[name].float() + n * acc.float()) / (n + 1))
        if n == self.k - 1:
            self.inner.update(self.acc)   # clips the mean in place
            for acc in self.acc.values():
                acc.zero_()
            self.mini_step = 0
        else:
            self.mini_step = n + 1
        return norm

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        _copy_into(self.acc, state["acc"])
        self.mini_step = int(state["mini_step"])


def build_optimizer(model: nn.Module, cfg: TrainConfig):
    """Optimizer, wrapped in MultiSteps when gradients accumulate."""
    opt = Optimizer(model, cfg)
    if cfg.grad_accum_steps > 1:
        return MultiSteps(opt, cfg.grad_accum_steps)
    return opt


class TrainState(NamedTuple):
    step: int
    model: nn.Module
    opt: "Optimizer | MultiSteps"

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig,
               lora_cfg=None) -> "TrainState":
        """Freezes what the train set leaves out and builds the optimizer
        state for the rest."""
        if lora_cfg is not None:
            raise NotImplementedError("LoRA is not ported yet")
        apply_trainable_mask(model, cfg)
        return cls(0, model, build_optimizer(model, cfg))
