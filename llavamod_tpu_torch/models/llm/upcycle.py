"""Sparse upcycling: a dense decoder becomes a top-k MoE (port of
llavamod_tpu/models/llm/upcycle.py).

    moe_cfg, moe_decoder = upcycle(cfg, decoder, moe_mode="sparse", ...)

Every expert starts as an exact copy of the dense FFN weights and the router
is zero, so initial routing is uniform.  The dense module is not changed:
the MoE module is built on the meta device and adopts the copied tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from llavamod_tpu_torch.models.llm import decoder as dec
from llavamod_tpu_torch.models.llm import config as llm_config
from llavamod_tpu_torch.models.llm.config import DecoderConfig


def moe_layer_indices(moe_mode: str, num_layers: int,
                      explicit: Optional[Sequence[int]] = None
                      ) -> Tuple[int, ...]:
    """Layer selection per moe_mode, or the explicit list."""
    if explicit is not None:
        if not explicit or len(explicit) > num_layers \
                or max(explicit) >= num_layers or min(explicit) < 0:
            raise ValueError(f"MoE layers {tuple(explicit)} do not fit a "
                             f"{num_layers}-layer decoder")
        return tuple(explicit)
    return llm_config.moe_layer_indices(moe_mode, num_layers)


def upcycle(
    cfg: DecoderConfig,
    model: dec.Decoder,
    *,
    moe_mode: str = "sparse",
    moe_layers_idx: Optional[Sequence[int]] = None,
    num_experts: int = 4,
    top_k: int = 2,
    capacity_factor: float = 1.5,
    eval_capacity_factor: float = 2.0,
    min_capacity: int = 4,
    use_residual: bool = False,
    router_aux_loss_coef: float = 0.01,
) -> Tuple[DecoderConfig, dec.Decoder]:
    """Returns (moe_cfg, moe_decoder) on the dense decoder's device and in
    its dtype.  `model` is not mutated."""
    layers_idx = moe_layer_indices(moe_mode, cfg.num_layers, moe_layers_idx)
    moe_cfg = cfg.replace(
        moe_num_experts=num_experts,
        moe_top_k=top_k,
        moe_capacity_factor=capacity_factor,
        moe_eval_capacity_factor=eval_capacity_factor,
        moe_min_capacity=min_capacity,
        moe_layers=layers_idx,
        moe_use_residual=use_residual,
        router_aux_loss_coef=router_aux_loss_coef,
    )
    state = {}
    for key, w in model.state_dict().items():
        parts = key.split(".")
        if parts[0] != "layers" or parts[2] != "mlp" \
                or int(parts[1]) not in layers_idx:
            state[key] = w.clone()
            continue
        head, leaf = ".".join(parts[:3]), ".".join(parts[3:])
        state[f"{head}.experts.{leaf}"] = w.unsqueeze(0).repeat(
            (num_experts,) + (1,) * w.dim())
        if use_residual:
            state[f"{head}.residual_mlp.{leaf}"] = w.clone()
    ref = model.embed.embedding
    for i in layers_idx:
        state[f"layers.{i}.mlp.router"] = torch.zeros(
            (cfg.hidden_size, num_experts), dtype=ref.dtype, device=ref.device)
        if use_residual:
            state[f"layers.{i}.mlp.coef"] = torch.zeros(
                (cfg.hidden_size, 2), dtype=ref.dtype, device=ref.device)
    moe = dec.Decoder(moe_cfg, generator=None, device="meta", dtype=ref.dtype)
    moe.load_state_dict(state, strict=True, assign=True)
    return moe_cfg, moe
