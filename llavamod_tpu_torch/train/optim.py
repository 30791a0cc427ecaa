"""Trainable sets, learning-rate schedules, AdamW and Adafactor (port of
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
step.

With LoRA (models/lora.py) the optimizer takes the adapters as well,
under 'lora.<target>.a' / '.b' keys: they always train, the targets they
adapt are frozen (PEFT wraps and freezes them), everything else follows the
usual rules, as the JAX mask over its {'base', 'lora'} tree.

Adafactor (`optimizer='adafactor'`) follows the JAX `_adafactor`: optax's
adafactor with decay rate 0.8, parameter scale, update clipping at 1.0 in
place of the global-norm clip, no momentum, `weight_decay_rate =
weight_decay or None`, per label as AdamW.  Its rule is
train/adafactor.py's, whose blocks are single parameter tensors (see
there); its factored state is a few MB where AdamW's moments are twice the
trainable bytes.

On a model that parallel/sharding.py `shard_params` wrapped (`pctx`, the
mesh's ParallelContext), every state tensor is the rank's shard of the
parameter's: AdamW and MultiSteps are elementwise and run on the local
shards; the global norm counts every gradient entry once (a shard's square
sum is summed over the world and divided by the ranks that hold a copy of
it: a parameter that `tensor` leaves whole is held by every tensor rank,
one outside the decoder layers by every pipe stage, a layer's by its own
stage only);
Adafactor's means over a sharded dim, and over a whole tensor, sum over
the shard groups (train/adafactor.py `shards`), the tensor group of a
tensor-split dim included.  LoRA adapters beside a sharded model
(parallel/sharding.py `shard_lora`) are plain tensors, whole or the
rank's experts and tensor slice; their state is theirs alike.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

from llavamod_tpu_torch.parallel.sharding import local_tensor
from llavamod_tpu_torch.train import adafactor
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
    unless frozen) select the set, and an empty set trains everything.  With
    `lora_cfg`, the parameters its adapters target are frozen."""
    from llavamod_tpu_torch.models.lora import is_target

    def decide(p: str) -> bool:
        if lora_cfg is not None and is_target(p, lora_cfg):
            return False
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


def param_labels(model: nn.Module, cfg: TrainConfig,
                 lora_cfg=None) -> Dict[str, str]:
    """{key: 'frozen' | 'projector' | 'default'} (the multi_transform
    labels)."""
    mask = trainable_mask(model, cfg, lora_cfg)

    def label(n: str) -> str:
        if not mask[n]:
            return "frozen"
        if _is_projector(_path(n)) and cfg.mm_projector_lr:
            return "projector"
        return "default"

    return {n: label(n) for n in mask}


def apply_trainable_mask(model: nn.Module, cfg: TrainConfig,
                         lora_cfg=None) -> Dict[str, bool]:
    """Set requires_grad from `trainable_mask`; returns the mask."""
    mask = trainable_mask(model, cfg, lora_cfg)
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


def global_norm(grads, weights=None) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, in f32.  With
    `weights` ({key: 1 / copies}, `Optimizer.norm_weights`) `grads` is a
    dict of this rank's shards and the sum runs over the world."""
    if weights is None:
        sq = [g.float().pow(2).sum() for g in grads if g is not None]
        return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
    import torch.distributed as dist

    sq = [local_tensor(g).float().pow(2).sum() * weights[n]
          for n, g in grads.items()]
    total = torch.stack(sq).sum()
    dist.all_reduce(total)
    return torch.sqrt(total)


class AdamW:
    """optax.adamw over one label group of parameters."""

    def __init__(self, params: Dict[str, nn.Parameter], cfg: TrainConfig,
                 lr: float, shards=None):
        self.params = params
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, lr)
        self.mu = {n: torch.zeros_like(local_tensor(p))
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(local_tensor(p))
                   for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.adam_b1 ** self.count
        bc2 = 1.0 - cfg.adam_b2 ** self.count
        for n, p in self.params.items():
            p = local_tensor(p)
            g = local_tensor(grads[n]).float()
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


class Adafactor:
    """optax.adafactor (the JAX `_adafactor` settings) over one label group
    of parameters, with train/adafactor.py's per-tensor rule.

    `update_leaf` updates one parameter at the current count without
    advancing it, and `advance` ends the update: the fused step applies
    the rule layer by layer inside its backward; `update` does both for a
    whole gradient dict."""

    def __init__(self, params: Dict[str, nn.Parameter], cfg: TrainConfig,
                 lr: float, shards=None):
        self.params = params
        self.schedule = make_lr_schedule(cfg, lr)
        self.shards = shards or {}
        self.state = {n: adafactor.init_leaf(local_tensor(p),
                                             self._shape(n, p))
                      for n, p in params.items()}
        self.count = 0
        self.weight_decay_rate = cfg.weight_decay or None

    def _shape(self, name: str, p) -> tuple:
        return self.shards[name][0] if name in self.shards else tuple(p.shape)

    @torch.no_grad()
    def update_leaf(self, name: str, grad: torch.Tensor) -> None:
        p = local_tensor(self.params[name])
        new_p, self.state[name] = adafactor.update_leaf(
            p, local_tensor(grad), self.state[name], self.count,
            self.schedule(self.count),
            weight_decay_rate=self.weight_decay_rate,
            shards=self.shards.get(name))
        p.copy_(new_p)

    def advance(self) -> None:
        self.count += 1

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        for n in self.params:
            self.update_leaf(n, grads[n])
        self.advance()

    def state_dict(self) -> dict:
        return {"state": self.state, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        if self.state.keys() != state["state"].keys():
            raise ValueError("state keys differ: " + str(sorted(
                self.state.keys() ^ state["state"].keys())[:4]))
        for n, s in self.state.items():
            _copy_into(s, state["state"][n])
        self.count = int(state["count"])


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    if dst.keys() != src.keys():
        raise ValueError(f"state keys differ: {sorted(dst.keys() ^ src.keys())[:4]}")
    for n, t in dst.items():
        t.copy_(src[n])


_GROUP_CLASSES = {"adamw": AdamW, "adafactor": Adafactor}


class Optimizer:
    """clip_by_global_norm (AdamW only), then AdamW or Adafactor per label;
    frozen parameters are left as they are (optax.set_to_zero)."""

    def __init__(self, model: nn.Module, cfg: TrainConfig, lora=None,
                 lora_cfg=None, pctx=None):
        if cfg.optimizer not in _GROUP_CLASSES:
            raise ValueError(f"optimizer must be one of "
                             f"{sorted(_GROUP_CLASSES)}; got {cfg.optimizer!r}")
        self.cfg = cfg
        labels = param_labels(model, cfg, lora_cfg)
        named = dict(model.named_parameters())
        if lora is not None:       # the adapters train, at the default lr
            for n, p in lora.named_parameters():
                named["lora." + n] = p
                labels["lora." + n] = "default"
        lrs = {"default": cfg.learning_rate,
               "projector": cfg.mm_projector_lr or cfg.learning_rate}
        group_cls = _GROUP_CLASSES[cfg.optimizer]
        # sharded parameters: {key: (global shape, {dim: [(group, size)]})}
        # and the weight of a shard's square sum in the world's norm
        splits = dict(getattr(model, "tensor_split", {}))
        if lora is not None:
            splits.update({"lora." + k: v for k, v in
                           getattr(lora, "tensor_split", {}).items()})
        self.shards = {n: pctx.shard_groups(
            n, named[n], splits[n].dim if n in splits else None)
            for n, lb in labels.items()
            if lb != "frozen"} if pctx is not None else {}
        self.norm_weights = None
        if pctx is not None:
            from llavamod_tpu_torch.parallel.pipeline import is_stage_key

            self.norm_weights = {}
            for n, (_, dims) in self.shards.items():
                held = 1
                for groups in dims.values():
                    for _, size in groups:
                        held *= size
                if is_stage_key(n):         # on one pipeline stage only
                    held *= pctx.pipe_size
                self.norm_weights[n] = held / pctx.world
        self.groups = {
            lab: group_cls({n: named[n] for n, lb in labels.items()
                            if lb == lab}, cfg, lr, self.shards)
            for lab, lr in lrs.items()}

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return {n: p for g in self.groups.values() for n, p in g.params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update from {key: gradient} of every trainable parameter.
        With AdamW the gradients are clipped in place; returns their global
        norm before clipping."""
        norm = self.norm(grads)
        if (self.cfg.optimizer == "adamw" and self.cfg.max_grad_norm
                and norm >= self.cfg.max_grad_norm):
            for g in grads.values():
                g = local_tensor(g)
                g.div_(norm.to(g.dtype)).mul_(self.cfg.max_grad_norm)
        for group in self.groups.values():
            group.update(grads)
        return norm

    def norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of {key: gradient} (sharded or whole)."""
        if self.norm_weights is None:
            return global_norm(grads.values())
        return global_norm(grads, self.norm_weights)

    @property
    def updates(self) -> int:
        """Optimizer updates applied so far."""
        return next(iter(self.groups.values())).count

    def update_leaf(self, name: str, grad: torch.Tensor) -> None:
        """Adafactor: update one parameter, in its label's group, at the
        current count (the fused step; `advance` ends the update)."""
        for group in self.groups.values():
            if name in group.params:
                group.update_leaf(name, grad)
                return
        raise KeyError(f"{name} is not a trainable parameter")

    def advance(self) -> None:
        for group in self.groups.values():
            group.advance()

    def state_dict(self) -> dict:
        return {lab: g.state_dict() for lab, g in self.groups.items()}

    def load_state_dict(self, state: dict) -> None:
        for lab, g in self.groups.items():
            g.load_state_dict(state[lab])


class MultiSteps:
    """optax.MultiSteps(Optimizer, k): every call folds the microbatch
    gradients into a running mean, (g + n * acc) / (n + 1), kept in the
    gradient's dtype; the k-th call hands the mean to the inner optimizer
    (clip and AdamW, or Adafactor) and starts a new mean."""

    def __init__(self, inner: Optimizer, k: int):
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(local_tensor(p))
                    for n, p in inner.params.items()}

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
        norm = self.inner.norm(grads)
        n = self.mini_step
        for name, acc in self.acc.items():
            acc.copy_((local_tensor(grads[name]).float() + n * acc.float())
                      / (n + 1))
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
        """A state without "acc" (a sharded checkpoint at an update
        boundary) leaves the accumulator zero."""
        self.inner.load_state_dict(state["inner"])
        if "acc" in state:
            _copy_into(self.acc, state["acc"])
        else:
            for acc in self.acc.values():
                acc.zero_()
        self.mini_step = int(state["mini_step"])


def build_optimizer(model: nn.Module, cfg: TrainConfig, lora=None,
                    lora_cfg=None, pctx=None):
    """Optimizer, wrapped in MultiSteps when gradients accumulate."""
    opt = Optimizer(model, cfg, lora, lora_cfg, pctx)
    if cfg.grad_accum_steps > 1:
        return MultiSteps(opt, cfg.grad_accum_steps)
    return opt


class TrainState(NamedTuple):
    step: int
    model: nn.Module
    opt: "Optimizer | MultiSteps"
    lora: "nn.Module | None" = None    # models/lora.py LoraAdapters

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig, lora_cfg=None,
               lora=None, pctx=None) -> "TrainState":
        """Freezes what the train set leaves out (and, with adapters, the
        parameters they target) and builds the optimizer state for the
        rest and the adapters (on the rank's shards of a model sharded on
        `pctx`'s mesh)."""
        if (lora is None) != (lora_cfg is None):
            raise ValueError("LoRA needs both the adapters and their config")
        apply_trainable_mask(model, cfg, lora_cfg)
        if lora is not None:
            lora.requires_grad_(True)
        return cls(0, model, build_optimizer(model, cfg, lora, lora_cfg,
                                             pctx), lora)
