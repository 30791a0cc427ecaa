"""Sparse Mixture-of-Experts: top-k gating and expert dispatch (port of
llavamod_tpu/ops/moe.py).

DeepSpeed top1/top2 gating semantics, as in the JAX package:
  * router softmax in f32; argmax takes the first of tied values; each later
    choice masks out the earlier ones with -inf;
  * capacity = max(min_capacity, ceil(tokens/E * capacity_factor * k)) with
    an integer ceil;
  * within an expert, choice-2 tokens are placed after all choice-1 tokens
    (exclusive cumsum offset by the earlier choices' counts);
  * combine weights renormalised over the kept choices (k >= 2).
Padding tokens (token_valid False) claim no capacity.  `train` picks the
capacity factor (1.5 in training, 2.0 in eval by default).  The gating
functions take router logits [S, E], or [G, S, E] for G independent gating
groups (the JAX package vmaps them over groups); every output then carries
the leading G axis, the aux loss included.

Four dispatch layouts route the same assignment:
  * `moe_ffn` — one-hot dispatch / combine einsums over [S, E, C]
    (`top_k_gating`);
  * `moe_ffn_gather` / `moe_ffn_gather_grouped` — gather into the
    capacity-padded [E, C, D] (or [E, G*C, D]) batch and scatter back;
  * `moe_ffn_ragged` / `moe_ffn_ragged_grouped` — only the kept rows,
    compacted expert-major for a ragged per-expert product.

Gradients follow the JAX package: the choices, slots and drops are integer
bookkeeping and carry none; the combine weights carry it through the gate
probabilities of the kept choices and their renormalising sum; the aux loss
mean(me * ce) * E^2 carries it through me (the mean gate) only, ce being a
count of top-1 choices; the gathers and scatters are differentiable in the
tokens and in the expert weights.
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


class GatingOutput(NamedTuple):
    """One-hot form of the top-k assignment (for einsum dispatch)."""
    dispatch: torch.Tensor      # [S, E, C] f32 (0/1) — token -> slot
    combine: torch.Tensor       # [S, E, C] f32 — renormalized gate weights
    aux_loss: torch.Tensor      # scalar load-balance loss
    expert_load: torch.Tensor   # [E] share of tokens whose top-1 is e
    router_probs: torch.Tensor  # [S, E] softmax gate probabilities


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
    """Shared top-k + capacity bookkeeping (DeepSpeed top1/top2 semantics)
    over logits [..., S, E]; every group of S tokens is gated on its own."""
    s, e = router_logits.shape[-2:]
    k = cfg.top_k
    cap = cfg.capacity(s, train)

    gates = torch.softmax(router_logits.float(), dim=-1)  # [..., S, E]
    if token_valid is None:
        valid_f = torch.ones(gates.shape[:-1], dtype=torch.float32,
                             device=gates.device)
    else:
        valid_f = token_valid.float()

    remaining = gates
    masks = []
    gate_vals = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e).float() * valid_f[..., None]
        masks.append(onehot)
        gate_vals.append((gates * onehot).sum(dim=-1))
        remaining = torch.where(onehot > 0, float("-inf"), remaining)

    denom_v = valid_f.sum(dim=-1, keepdim=True).clamp_min(1.0)
    me = (gates * valid_f[..., None]).sum(dim=-2) / denom_v
    ce = masks[0].sum(dim=-2) / denom_v
    aux = ((me * ce).sum(dim=-1) * e if k == 1
           else (me * ce).mean(dim=-1) * e * e)

    prior = torch.zeros(gates.shape[:-2] + (e,), dtype=torch.float32,
                        device=gates.device)
    kept_masks = []
    locations = []
    for choice in range(k):
        m = masks[choice]
        # exclusive cumsum over the tokens
        loc = torch.cumsum(m, dim=-2) - m + prior[..., None, :]
        kept_masks.append(m * (loc < cap))
        locations.append(loc)
        prior = prior + m.sum(dim=-2)

    kept_gate = [gate_vals[c] * kept_masks[c].sum(dim=-1) for c in range(k)]
    if k == 1:
        denom = torch.ones_like(kept_gate[0])
    else:
        denom = sum(kept_gate).clamp_min(torch.finfo(torch.float32).eps)
    return dict(masks=masks, kept_masks=kept_masks, locations=locations,
                kept_gate=kept_gate, denom=denom, aux=aux, ce=ce,
                gates=gates, cap=cap, k=k, s=s, e=e)


def top_k_gating(router_logits: torch.Tensor, cfg: GatingConfig, *,
                 train: bool = True,
                 token_valid: Optional[torch.Tensor] = None) -> GatingOutput:
    """router_logits [(G,) S, E] -> the top-k assignment as dispatch and
    combine one-hots [(G,) S, E, C]."""
    g = _gating_core(router_logits, cfg, train, token_valid)
    cap, k = g["cap"], g["k"]
    shape = g["gates"].shape + (cap,)
    combine = torch.zeros(shape, dtype=torch.float32,
                          device=router_logits.device)
    dispatch = torch.zeros_like(combine)
    for c in range(k):
        pos = (g["locations"][c] * g["kept_masks"][c]).sum(dim=-1)
        pos_oh = torch.nn.functional.one_hot(pos.long(), cap).float()
        w = (g["kept_gate"][c] / g["denom"])[..., None, None]
        contrib = g["kept_masks"][c][..., None] * pos_oh[..., None, :]
        combine = combine + w * contrib
        dispatch = dispatch + contrib
    return GatingOutput(dispatch.detach(), combine, g["aux"], g["ce"],
                        g["gates"])


def top_k_gating_compact(router_logits: torch.Tensor, cfg: GatingConfig, *,
                         train: bool = True,
                         token_valid: Optional[torch.Tensor] = None
                         ) -> CompactGating:
    """router_logits [(G,) S, E] -> the top-k assignment in index/weight
    form, fields [(G,) S, k]."""
    g = _gating_core(router_logits, cfg, train, token_valid)
    k = g["k"]
    expert = torch.stack([torch.argmax(g["masks"][c], dim=-1).to(torch.int32)
                          for c in range(k)], dim=-1)
    slot = torch.stack([(g["locations"][c] * g["kept_masks"][c]).sum(dim=-1)
                        .to(torch.int32) for c in range(k)], dim=-1)
    kept = torch.stack([g["kept_masks"][c].sum(dim=-1) > 0
                        for c in range(k)], dim=-1)
    weight = torch.stack([g["kept_gate"][c] / g["denom"] for c in range(k)],
                         dim=-1)
    weight = weight * kept.to(weight.dtype)
    return CompactGating(expert, slot, weight, kept, g["aux"], g["ce"],
                         g["gates"])


def moe_ffn(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
            expert_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Route tokens through experts by dense one-hot contractions.
    x [S, D]; dispatch / combine [S, E, C]; expert_fn maps [E, C, D] ->
    [E, C, D]."""
    xe = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), x)
    ye = expert_fn(xe)
    return torch.einsum("sec,ecd->sd", combine.to(ye.dtype), ye)


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
    token_ids = torch.arange(s, device=x.device).repeat_interleave(k)
    src, filled = _scatter_sources(flat.reshape(s * k), token_ids, e * cap)

    xe = torch.where(filled[:, None], x[src], 0)
    ye = expert_fn(xe.reshape(e, cap, d)).reshape(e * cap, d)

    picked = ye[flat.clamp_max(e * cap - 1).reshape(s * k)].reshape(s, k, d)
    w = gating.weight.float()[..., None]                            # 0 for dropped
    y = (picked.float() * w).sum(dim=1)
    return y.to(x.dtype)


def _scatter_sources(flat: torch.Tensor, token_ids: torch.Tensor, rows: int):
    """rows -> (source token, filled) for the distinct targets `flat` of
    the kept choices; dropped choices point at a spill row that is cut."""
    src = torch.zeros((rows + 1,), dtype=torch.long, device=flat.device)
    src[flat] = token_ids
    # index_fill_ takes the value as a scalar argument; an indexed
    # assignment of True copies a host tensor to the card, which a CUDA
    # graph capture refuses
    filled = torch.zeros((rows + 1,), dtype=torch.bool,
                         device=flat.device).index_fill_(0, flat, True)
    return src[:-1], filled[:-1]


def moe_ffn_gather_grouped(x: torch.Tensor, gating: CompactGating,
                           num_experts: int, capacity: int, group: int,
                           expert_fn: Callable[[torch.Tensor], torch.Tensor]
                           ) -> torch.Tensor:
    """Gather dispatch for per-group gating: gating fields [G, group, k];
    every expert sees all groups' capacity rows, group-major ([E, G*C, D],
    the layout of decoder `_grouped_moe`).  x [G*group, D] -> [G*group, D]."""
    s, d = x.shape
    e, cap = num_experts, capacity
    g_n, grp, k = gating.expert.shape
    if g_n * grp != s:
        raise ValueError(f"gating {tuple(gating.expert.shape)} does not tile "
                         f"{s} tokens")
    rows = g_n * cap                  # capacity rows per expert across groups
    g_idx = torch.arange(g_n, device=x.device)[:, None, None]
    flat = gating.expert.long() * rows + g_idx * cap + gating.slot.long()
    flat = torch.where(gating.kept, flat, e * rows)         # dropped -> spill
    token_ids = (g_idx * grp + torch.arange(grp, device=x.device)[None, :, None]
                 ).expand(flat.shape).reshape(-1)
    src, filled = _scatter_sources(flat.reshape(-1), token_ids, e * rows)

    xe = torch.where(filled[:, None], x[src], 0)
    ye = expert_fn(xe.reshape(e, rows, d)).reshape(e * rows, d)

    picked = ye[flat.clamp_max(e * rows - 1).reshape(-1)].reshape(s, k, d)
    w = gating.weight.float().reshape(s, k)[..., None]
    y = (picked.float() * w).sum(dim=1)
    return y.to(x.dtype)


def _ragged_rows(expert, slot, kept, offsets, m: int):
    """Shared tail of the ragged layouts: each kept (token, choice) goes to
    its compacted row `offsets[expert] + slot` (dropped -> m, out of
    range), with the row -> source-token gather index."""
    r = offsets[expert.long()] + slot.long()
    r = torch.where(kept, r, m)                               # [S, k]
    s, k = expert.shape
    token_ids = torch.arange(s, device=expert.device).repeat_interleave(k)
    src, filled = _scatter_sources(r.reshape(-1), token_ids, m)
    return r, src, filled


def _ragged_combine(x, yr, r, kept, weight, m: int) -> torch.Tensor:
    s, k = r.shape
    picked = yr[r.clamp_max(m - 1).reshape(-1)].reshape(s, k, -1)
    picked = torch.where(kept[..., None], picked, 0)          # no NaN leak
    w = weight.float()[..., None]
    return (picked.float() * w).sum(dim=1).to(x.dtype)


def moe_ffn_ragged(x: torch.Tensor, gating: CompactGating, num_experts: int,
                   capacity: int,
                   expert_fn_ragged: Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor]) -> torch.Tensor:
    """Same routing as `moe_ffn_gather`, but the experts run as a ragged
    product over only the kept rows instead of the capacity-padded
    [E, C, D] batch.  Within an expert the kept slots are 0..count-1
    (exclusive cumsum, choice-major), so `offsets[e] + slot` gives the
    contiguous expert-major row blocks of a ragged product with group
    sizes = the per-expert kept counts.  Identical drops and weights.

    x [S, D]; expert_fn_ragged maps ([M, D], group_sizes [E]) -> [M, D]."""
    s, _ = x.shape
    k = gating.expert.shape[1]
    m = min(s * k, num_experts * capacity)
    counts = torch.zeros((num_experts,), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, gating.expert.reshape(-1).long(),
                        gating.kept.reshape(-1).long())
    offsets = torch.cumsum(counts, 0) - counts                 # exclusive
    r, src, filled = _ragged_rows(gating.expert, gating.slot, gating.kept,
                                  offsets, m)
    xr = torch.where(filled[:, None], x[src], 0)
    yr = expert_fn_ragged(xr, counts)
    return _ragged_combine(x, yr, r, gating.kept, gating.weight, m)


def moe_ffn_ragged_grouped(x: torch.Tensor, gating: CompactGating,
                           num_experts: int, capacity: int, group: int,
                           expert_fn_ragged: Callable[[torch.Tensor,
                                                       torch.Tensor],
                                                      torch.Tensor]
                           ) -> torch.Tensor:
    """Ragged dispatch for per-group gating (fields [G, group, k]): each
    expert's row block is the group-major concatenation of every group's
    kept rows for that expert (slot offsets chain the per-group counts),
    so one ragged product covers all groups.  x [G*group, D] -> same."""
    s, _ = x.shape
    e = num_experts
    g_n, grp, k = gating.expert.shape
    if g_n * grp != s:
        raise ValueError(f"gating {tuple(gating.expert.shape)} does not tile "
                         f"{s} tokens")
    m = min(s * k, e * g_n * capacity)
    onehot = torch.nn.functional.one_hot(gating.expert.long(), e)
    counts_ge = (onehot * gating.kept[..., None]).sum(dim=(1, 2))   # [G, E]
    counts = counts_ge.sum(dim=0)
    offsets = torch.cumsum(counts, 0) - counts
    base_ge = torch.cumsum(counts_ge, 0) - counts_ge                # [G, E]
    slot = (torch.gather(base_ge, 1, gating.expert.long().reshape(g_n, -1))
            .reshape(g_n, grp, k) + gating.slot.long())
    kept = gating.kept.reshape(s, k)
    r, src, filled = _ragged_rows(gating.expert.reshape(s, k),
                                  slot.reshape(s, k), kept, offsets, m)
    xr = torch.where(filled[:, None], x[src], 0)
    yr = expert_fn_ragged(xr, counts)
    return _ragged_combine(x, yr, r, kept, gating.weight.reshape(s, k), m)
