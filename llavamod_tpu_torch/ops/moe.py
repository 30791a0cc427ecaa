"""Sparse Mixture-of-Experts: top-k gating and gather dispatch (port of
llavamod_tpu/ops/moe.py, gather dispatch, for training and serving).

DeepSpeed top1/top2 gating semantics, as in the JAX package:
  * router softmax in f32; argmax takes the first of tied values; each later
    choice masks out the earlier ones with -inf;
  * capacity = max(min_capacity, ceil(tokens/E * capacity_factor * k)) with
    an integer ceil;
  * within an expert, choice-2 tokens are placed after all choice-1 tokens
    (exclusive cumsum offset by the earlier choices' counts);
  * combine weights renormalised over the kept choices (k >= 2).
Padding tokens (token_valid False) claim no capacity.  `train` picks the
capacity factor (1.5 in training, 2.0 in eval by default).

Gradients follow the JAX package: the choices, slots and drops are integer
bookkeeping and carry none; the combine weights carry it through the gate
probabilities of the kept choices and their renormalising sum; the aux loss
mean(me * ce) * E^2 carries it through me (the mean gate) only, ce being a
count of top-1 choices; the gather and scatter of `moe_ffn_gather` are
differentiable in the tokens and in the expert weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class GatingConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.5      # train
    eval_capacity_factor: float = 2.0  # eval
    min_capacity: int = 4
    router_jitter: float = 0.0
    deterministic_capacity: Optional[int] = None

    def capacity(self, num_tokens: int, train: bool) -> int:
        if self.deterministic_capacity is not None:
            return self.deterministic_capacity
        f = self.capacity_factor if train else self.eval_capacity_factor
        cap = int(-(-num_tokens * f * self.top_k // self.num_experts))
        return max(cap, self.min_capacity)


class CompactGating(NamedTuple):
    """Index/weight form of the top-k assignment (for gather dispatch)."""
    expert: torch.Tensor       # [S, k] int32 — chosen expert per choice
    slot: torch.Tensor         # [S, k] int32 — capacity slot within expert
    weight: torch.Tensor       # [S, k] f32 — renormalized gate (0 if dropped)
    kept: torch.Tensor         # [S, k] bool — survived the capacity drop
    aux_loss: torch.Tensor     # scalar
    expert_load: torch.Tensor  # [E]
    router_probs: torch.Tensor  # [S, E]


def _gating_core(router_logits: torch.Tensor, cfg: GatingConfig, train: bool,
                 token_valid: Optional[torch.Tensor]):
    """Shared top-k + capacity bookkeeping (DeepSpeed top1/top2 semantics)."""
    s, e = router_logits.shape
    k = cfg.top_k
    cap = cfg.capacity(s, train)

    gates = torch.softmax(router_logits.float(), dim=-1)  # [S, E]
    if token_valid is None:
        valid_f = torch.ones((s,), dtype=torch.float32, device=gates.device)
    else:
        valid_f = token_valid.float()

    remaining = gates
    masks = []
    gate_vals = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e).float() * valid_f[:, None]
        masks.append(onehot)
        gate_vals.append((gates * onehot).sum(dim=-1))
        remaining = torch.where(onehot > 0, float("-inf"), remaining)

    denom_v = valid_f.sum().clamp_min(1.0)
    me = (gates * valid_f[:, None]).sum(dim=0) / denom_v
    ce = masks[0].sum(dim=0) / denom_v
    aux = (me * ce).sum() * e if k == 1 else (me * ce).mean() * e * e

    prior = torch.zeros((e,), dtype=torch.float32, device=gates.device)
    kept_masks = []
    locations = []
    for choice in range(k):
        m = masks[choice]
        loc = torch.cumsum(m, dim=0) - m + prior[None, :]  # exclusive cumsum
        kept_masks.append(m * (loc < cap))
        locations.append(loc)
        prior = prior + m.sum(dim=0)

    kept_gate = [gate_vals[c] * kept_masks[c].sum(dim=-1) for c in range(k)]
    if k == 1:
        denom = torch.ones_like(kept_gate[0])
    else:
        denom = sum(kept_gate).clamp_min(torch.finfo(torch.float32).eps)
    return dict(masks=masks, kept_masks=kept_masks, locations=locations,
                kept_gate=kept_gate, denom=denom, aux=aux, ce=ce,
                gates=gates, cap=cap, k=k, s=s, e=e)


def top_k_gating_compact(router_logits: torch.Tensor, cfg: GatingConfig, *,
                         train: bool = True,
                         token_valid: Optional[torch.Tensor] = None
                         ) -> CompactGating:
    """router_logits [S, E] -> the top-k assignment in index/weight form."""
    g = _gating_core(router_logits, cfg, train, token_valid)
    k = g["k"]
    expert = torch.stack([torch.argmax(g["masks"][c], dim=-1).to(torch.int32)
                          for c in range(k)], dim=1)
    slot = torch.stack([(g["locations"][c] * g["kept_masks"][c]).sum(dim=-1)
                        .to(torch.int32) for c in range(k)], dim=1)
    kept = torch.stack([g["kept_masks"][c].sum(dim=-1) > 0
                        for c in range(k)], dim=1)
    weight = torch.stack([g["kept_gate"][c] / g["denom"] for c in range(k)],
                         dim=1)
    weight = weight * kept.to(weight.dtype)
    return CompactGating(expert, slot, weight, kept, g["aux"], g["ce"],
                         g["gates"])


def moe_ffn_gather(x: torch.Tensor, gating: CompactGating, num_experts: int,
                   capacity: int,
                   expert_fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """Route tokens through experts by gather/scatter.

    x: [S, D]; expert_fn maps [E, C, D] -> [E, C, D].  Every kept
    (expert, slot) pair is distinct by construction, so the scatter has no
    collisions; dropped choices go to a spill row that is cut away.
    """
    s, d = x.shape
    e, cap = num_experts, capacity
    k = gating.expert.shape[1]

    flat = gating.expert.long() * cap + gating.slot.long()          # [S, k]
    flat = torch.where(gating.kept, flat, e * cap)                  # dropped -> spill
    flat_1d = flat.reshape(s * k)
    token_ids = torch.arange(s, device=x.device).repeat_interleave(k)
    src = torch.zeros((e * cap + 1,), dtype=torch.long, device=x.device)
    src[flat_1d] = token_ids
    filled = torch.zeros((e * cap + 1,), dtype=torch.bool, device=x.device)
    filled[flat_1d] = True
    src, filled = src[:-1], filled[:-1]

    xe = torch.where(filled[:, None], x[src], 0)
    ye = expert_fn(xe.reshape(e, cap, d)).reshape(e * cap, d)

    picked = ye[flat.clamp_max(e * cap - 1).reshape(s * k)].reshape(s, k, d)
    w = gating.weight.float()[..., None]                            # 0 for dropped
    y = (picked.float() * w).sum(dim=1)
    return y.to(x.dtype)
