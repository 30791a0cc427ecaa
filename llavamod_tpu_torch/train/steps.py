"""Training steps (port of llavamod_tpu/train/steps.py: the stage-2
mimic-distillation step).

    step = make_align_step(student_cfg, teacher_cfg, tcfg)
    state, metrics = step(state, teacher, batch)

One step runs the frozen vision tower once for both models, the student
forward and backward (through the flash-attention Function, whose backward
is kernels K3 + K4 on the card) and the teacher forward under no_grad, the
vocab-chunked KD (+ CE for kd_lm) loss, the router aux loss, and the AdamW
update in place.  Parameters are cast to `compute_dtype` for the forward
when they are kept in another dtype (f32 masters), and the gradients flow
back to them through the cast, as the JAX `_cast_tree`.

`make_pretrain_step` and `make_dpo_step` are not ported yet (ROADMAP
Queue 1, item 2).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch
from torch import nn

from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llava import LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.ops.losses import kd_align_loss, kd_ce_align_loss
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState, apply_trainable_mask

Metrics = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@contextlib.contextmanager
def _cast_tree(module: nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of `module` reads as its
    cast to `dtype` (a differentiable copy; no copy where the dtype already
    matches).  The backward must run inside the block too, so that a
    rematerialised layer recomputes with the same cast weights."""
    saved = []
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                saved.append((mod, name, p))
                mod._parameters[name] = p.to(dtype)
    try:
        yield module
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def batch_from_arrays(d: Dict[str, Any], prefix: str = "",
                      device="cuda") -> MultimodalBatch:
    """A MultimodalBatch on `device` from a collator dict of arrays."""
    def g(k, key=None):
        return torch.as_tensor(d[key or prefix + k], device=device)

    return MultimodalBatch(
        input_ids=g("input_ids"), segment_ids=g("segment_ids"),
        image_mask=g("image_mask"), image_pos=g("image_pos"),
        pixels=g("pixels", "pixels"), pixel_valid=g("pixel_valid",
                                                    "pixel_valid"),
        labels=g("labels"))


def _stop_frozen(model: nn.Module, tcfg: TrainConfig, lora_cfg=None):
    """Frozen parameters take no gradient (requires_grad False), so autograd
    never forms their backward, as the JAX stop_gradient lets XLA drop it."""
    if lora_cfg is not None:
        raise NotImplementedError("LoRA is not ported yet")
    return apply_trainable_mask(model, tcfg)


def _student_forward(model, cfg: LlavaConfig, batch: MultimodalBatch,
                     tcfg: TrainConfig, tower_feats=None):
    """Inside `_cast_tree`: (LlavaOutput, head weight) of the student."""
    if tcfg.student_head_quant or tcfg.student_body_quant:
        raise NotImplementedError("int8 student heads and bodies are not "
                                  "ported yet (ROADMAP Queue 1, item 3)")
    dtype = _DTYPES[tcfg.compute_dtype]
    cbatch = batch._replace(pixels=batch.pixels.to(dtype))
    out = llava.forward(model, cfg, cbatch, train=True, remat=tcfg.remat,
                        attn_impl=tcfg.attn_impl, tower_feats=tower_feats)
    return out, llava.lm_head_weight(model, cfg)


def _can_share_tower(tcfg: TrainConfig, a: LlavaConfig, b: LlavaConfig) -> bool:
    return (tcfg.share_vision_tower and a.vision == b.vision
            and a.select_layer == b.select_layer
            and a.select_feature == b.select_feature
            and a.s2_scales == b.s2_scales
            and a.freeze_vision and b.freeze_vision)


def _shared_tower_feats(model, cfg: LlavaConfig, batch: MultimodalBatch,
                        tcfg: TrainConfig) -> torch.Tensor:
    """Inside `_cast_tree`: the frozen tower runs once; both models consume
    its features."""
    dtype = _DTYPES[tcfg.compute_dtype]
    pixels = batch.pixels.to(dtype).reshape((-1,) + tuple(batch.pixels.shape[2:]))
    with torch.no_grad():
        return llava.encode_tower(model, cfg, pixels)


def make_align_step(student_cfg: LlavaConfig, teacher_cfg: LlavaConfig,
                    tcfg: TrainConfig, lora_cfg=None) -> Callable:
    """step(state, teacher, batch) -> (state, metrics).

    Loss = KD (+ student CE if kd_lm) + router aux * coef.  `teacher` is a
    Llava module; built with `vision=False` it takes the student's tower
    features.  metrics: loss, loss/align, loss/lm (kd_lm), num_tokens,
    loss/moe_balance (MoE students), grad_norm (before clipping)."""
    vocab_limit = tcfg.kd_vocab_limit or min(student_cfg.llm.vocab_size,
                                             teacher_cfg.llm.vocab_size)
    share_tower = _can_share_tower(tcfg, student_cfg, teacher_cfg)
    dtype = _DTYPES[tcfg.compute_dtype]

    def teacher_forward(teacher, batch, tower_feats):
        tb = batch._replace(pixels=batch.pixels.to(dtype))
        with torch.no_grad():
            out = llava.forward(teacher, teacher_cfg, tb, train=False,
                                attn_impl=tcfg.attn_impl,
                                tower_feats=tower_feats)
            return out.hidden, llava.lm_head_weight(teacher, teacher_cfg)

    def loss_fn(model, teacher, batch: MultimodalBatch):
        tower = (_shared_tower_feats(model, student_cfg, batch, tcfg)
                 if share_tower else None)
        out, w_s = _student_forward(model, student_cfg, batch, tcfg, tower)
        h_t, w_t = teacher_forward(teacher, batch, tower)
        metrics: Metrics = {}
        kw = dict(vocab_limit=vocab_limit,
                  distill_all_tokens=tcfg.distill_all_tokens,
                  chunk=tcfg.vocab_chunk, int8_dh=tcfg.kd_int8_dh,
                  stream_dh=tcfg.kd_stream_dh)
        if tcfg.align_loss_type == "kd_lm":
            fused = kd_ce_align_loss(out.hidden, w_s, h_t, w_t, batch.labels,
                                     **kw)
            loss = fused.kd_loss + fused.ce_loss
            metrics["loss/align"] = fused.kd_loss
            metrics["loss/lm"] = fused.ce_loss
            metrics["num_tokens"] = fused.kd_tokens
        else:
            kd = kd_align_loss(out.hidden, w_s, h_t, w_t, batch.labels, **kw)
            loss = kd.loss
            metrics["loss/align"] = kd.loss
            metrics["num_tokens"] = kd.num_tokens
        if student_cfg.llm.is_moe and tcfg.moe_loss_enable:
            loss = loss + student_cfg.llm.router_aux_loss_coef * out.aux_loss
            metrics["loss/moe_balance"] = out.aux_loss
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, teacher: nn.Module, batch: MultimodalBatch):
        model = state.model
        _stop_frozen(model, tcfg, lora_cfg)
        params = state.opt.params
        for p in params.values():
            p.grad = None
        with _cast_tree(model, dtype), _cast_tree(teacher, dtype):
            loss, metrics = loss_fn(model, teacher, batch)
            loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = state.opt.update(grads)
        for p in params.values():
            p.grad = None
        return state._replace(step=state.step + 1), metrics

    return step
