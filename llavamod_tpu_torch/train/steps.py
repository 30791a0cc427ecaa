"""Training steps for the three pipeline stages (port of
llavamod_tpu/train/steps.py).

    step = make_pretrain_step(cfg, tcfg)              # stage 1 / SFT
    state, metrics = step(state, batch)
    step = make_align_step(student_cfg, teacher_cfg, tcfg)   # stage 2
    state, metrics = step(state, teacher, batch)
    step = make_dpo_step(policy_cfg, ref_cfg, tcfg)   # stage 3
    state, metrics = step(state, ref, batch_dict)

A step is one microbatch: forward and backward (attention through the
flash-attention Function, whose backward is kernels K3 + K4 on the card),
then `state.opt.update`, which applies AdamW in place, or with gradient
accumulation folds the gradients into MultiSteps' mean and updates on every
k-th call.  `grad_norm` is the global norm of the microbatch's gradients
before clipping.  Frozen models (teacher, DPO reference) run under no_grad,
on the student's frozen tower features where the towers are shareable.
Parameters are cast to `compute_dtype` for the forward when they are kept
in another dtype (f32 masters), and the gradients flow back to them through
the cast, as the JAX `_cast_tree`.  With LoRA (`lora_cfg`, the adapters in
`state.lora`) the adapted weights are merged on the fly each step
(models/lora.py `lora_merged`, the JAX `_effective_params`), before the
cast (on a sharded model, after each unit's gather in the compute dtype),
and the gradients reach the adapters through the merge.

Under a parallel context (parallel/collectives.py, one process per card,
the models wrapped by parallel/sharding.py `shard_params`) a step on the
rank's rows is its share of the single-process step on the rows of data x
fsdp x expert (the rows group): the token-mean losses divide by the rows
group's counts, the MoE blocks gate its tokens, the terms every rank
computes whole (the router aux loss, the DPO loss over the gathered pair
log-probs) count 1 / rows on each rank, and FSDP2 sums the gradients over
the rows group.  The ranks of a tensor group hold the same rows and the
same loss: a tensor-split parameter's gradient is the rank's slice of the
whole one, and a replicated one's is whole on every tensor rank, except
under sequence parallelism, where the decoder's replicated parameters
(norms, router, output biases) see only the rank's T-shard and their
gradients are summed over the group (`_sum_sequence_shards`).  The LoRA
adapters sit outside FSDP2 (parallel/sharding.py `shard_lora`): their
gradients are summed by hand (`reduce_adapter_grads`).  Under pipeline
parallelism the ranks along pipe hold the same rows and the same loss as
well: each stage's layers take their own gradients, and the gradients of
everything outside the layers are stage 0's, handed to every stage
(parallel/pipeline.py `replicated_grads`).  The metrics are the world's
values on every rank.  The models are called through their
module call, so that a sharded model gathers its parameters, and its
mixed-precision policy does the compute-dtype cast of `_cast_tree`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch
from torch import nn

from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llava import LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.models.llm.decoder import quantize_head_int8
from llavamod_tpu_torch.models.lora import lora_merged
from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.ops.losses import (
    dpo_loss,
    kd_align_loss,
    kd_ce_align_loss,
    sequence_log_prob,
    softmax_cross_entropy,
)
from llavamod_tpu_torch.parallel.collectives import (
    current as parallel_context,
)
from llavamod_tpu_torch.parallel.sharding import is_sharded
from llavamod_tpu_torch.runtime import trace
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState, apply_trainable_mask

Metrics = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# per-rank shares of the single-process value, summed over the world
_SHARED_METRICS = ("loss", "loss/align", "loss/lm")


def _count_reduce(pctx):
    return None if pctx is None else pctx.all_sum


def _once(x: torch.Tensor, pctx) -> torch.Tensor:
    """A term every rank computes whole, weighted to count once in the sum
    of the rows group's losses."""
    return x if pctx is None else x / pctx.rows


def _world_metrics(metrics: Metrics, pctx) -> Metrics:
    return metrics if pctx is None else pctx.reduce_metrics(metrics,
                                                            _SHARED_METRICS)


@contextlib.contextmanager
def _cast_tree(module: nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of `module` reads as its
    cast to `dtype` (a differentiable copy; no copy where the dtype already
    matches).  The backward must run inside the block too, so that a
    rematerialised layer recomputes with the same cast weights.  A sharded
    module is left as it is: its mixed-precision policy gathers its
    parameters in the compute dtype."""
    saved = []
    if is_sharded(module):
        yield module
        return
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

    def video(k):
        return g(k, k) if k in d else None

    return MultimodalBatch(
        input_ids=g("input_ids"), segment_ids=g("segment_ids"),
        image_mask=g("image_mask"), image_pos=g("image_pos"),
        pixels=g("pixels", "pixels"), pixel_valid=g("pixel_valid",
                                                    "pixel_valid"),
        labels=g("labels"), video_pixels=video("video_pixels"),
        video_valid=video("video_valid"))


def _stop_frozen(model: nn.Module, tcfg: TrainConfig, lora_cfg=None):
    """Frozen parameters take no gradient (requires_grad False), so autograd
    never forms their backward, as the JAX stop_gradient lets XLA drop it."""
    return apply_trainable_mask(model, tcfg, lora_cfg)


def _student_forward(model, cfg: LlavaConfig, batch: MultimodalBatch,
                     tcfg: TrainConfig, tower_feats=None):
    """Inside `_cast_tree`: (LlavaOutput, head weight) of the student.  An
    int8 body (student_body_quant) was quantized when the stage was built
    (train/run.py); with student_head_quant, a head still in float (a tied
    model's embedding, or any head under LoRA) is quantized here each step
    from the live weights, without a gradient."""
    dtype = _DTYPES[tcfg.compute_dtype]
    cbatch = batch._replace(pixels=batch.pixels.to(dtype))
    with trace.span("train.student_fwd", device=True):
        out = model(cbatch, cfg=cfg, train=True, remat=tcfg.remat,
                    attn_impl=tcfg.attn_impl, tower_feats=tower_feats)
        w_head = llava.lm_head_weight(model, cfg)
        if tcfg.student_head_quant and not isinstance(w_head, Int8Weight):
            with torch.no_grad():
                w_head = quantize_head_int8(w_head)
    return out, w_head


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
        with torch.no_grad(), trace.span("train.teacher_fwd", device=True):
            out = teacher(tb, cfg=teacher_cfg, train=False,
                          attn_impl=tcfg.attn_impl, tower_feats=tower_feats)
            return out.hidden, llava.lm_head_weight(teacher, teacher_cfg)

    def loss_fn(model, teacher, batch: MultimodalBatch):
        pctx = parallel_context()
        # the student's forward runs the frozen tower; a teacher without
        # its own takes the features
        out, w_s = _student_forward(model, student_cfg, batch, tcfg)
        h_t, w_t = teacher_forward(teacher, batch,
                                   out.tower_feats if share_tower else None)
        with trace.span("train.loss", device=True):
            return align_loss(out, w_s, h_t, w_t, batch, pctx)

    def align_loss(out, w_s, h_t, w_t, batch: MultimodalBatch, pctx):
        metrics: Metrics = {}
        kw = dict(vocab_limit=vocab_limit,
                  distill_all_tokens=tcfg.distill_all_tokens,
                  chunk=tcfg.vocab_chunk, int8_dh=tcfg.kd_int8_dh,
                  stream_dh=tcfg.kd_stream_dh,
                  count_reduce=_count_reduce(pctx))
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
            loss = loss + student_cfg.llm.router_aux_loss_coef * _once(
                out.aux_loss, pctx)
            metrics["loss/moe_balance"] = out.aux_loss
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, teacher: nn.Module, batch: MultimodalBatch):
        with trace.span("train.step", id=state.step, device=True):
            model = state.model
            _stop_frozen(model, tcfg, lora_cfg)
            _clear_grads(state)
            with lora_merged(model, state.lora, lora_cfg), \
                    _cast_tree(model, dtype), _cast_tree(teacher, dtype):
                loss, metrics = loss_fn(model, teacher, batch)
                with trace.span("train.backward", device=True):
                    loss.backward()
            return _apply_update(state, _world_metrics(metrics,
                                                       parallel_context()),
                                 student_cfg)

    return step


def _clear_grads(state: TrainState) -> None:
    for p in state.opt.params.values():
        p.grad = None


def _sum_sequence_shards(model: nn.Module, grads: Dict[str, torch.Tensor],
                         cfg: LlavaConfig) -> None:
    """Under sequence parallelism, sum over the tensor group, in place, the
    gradients of the decoder's parameters that `tensor` leaves whole: each
    rank's is the part of its T-shard."""
    from llavamod_tpu_torch.parallel.collectives import tensor_sum
    from llavamod_tpu_torch.parallel.sharding import local_tensor

    pctx = parallel_context()
    if pctx is None or pctx.tensor_size == 1 or \
            not cfg.llm.seq_shard_activations:
        return
    splits = getattr(model, "tensor_split", {})
    for n, g in grads.items():
        if n.startswith("llm.") and n not in splits:
            g = local_tensor(g)
            g.copy_(tensor_sum(g, pctx))


def _apply_update(state: TrainState, metrics: Metrics, cfg=None):
    """Hands the trainable parameters' gradients to the optimizer (AdamW,
    or MultiSteps' running mean) and clears them; returns the state one
    microbatch on and the metrics with `grad_norm`, the global norm of this
    microbatch's gradients before clipping.  `cfg`: the model's config
    (sequence parallelism, `_sum_sequence_shards`)."""
    params = state.opt.params
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items()}
    if cfg is not None:
        _sum_sequence_shards(state.model, grads, cfg)
    pctx = parallel_context()
    if pctx is not None and state.lora is not None:
        from llavamod_tpu_torch.parallel.sharding import reduce_adapter_grads

        reduce_adapter_grads(state.lora, grads, pctx)
    if pctx is not None and pctx.pipe_size > 1:
        from llavamod_tpu_torch.parallel.pipeline import replicated_grads

        replicated_grads(grads, pctx)
    metrics = {k: v.detach() for k, v in metrics.items()}
    # `applied`: this call updated the parameters (not only accumulated)
    with trace.span("train.update", device=True) as sp:
        updates = state.opt.updates
        metrics["grad_norm"] = state.opt.update(grads)
        sp.set(applied=state.opt.updates > updates)
    _clear_grads(state)
    return state._replace(step=state.step + 1), metrics


def _head_frozen(w_head) -> bool:
    """The head the loss is handed takes no gradient (an Int8Weight never
    does).  Decided from the leaf itself, not from the config: the JAX
    `_head_weight_frozen` derives the head's path from tie_word_embeddings
    while `lm_head_weight` prefers an explicit lm_head leaf (ROADMAP Queue
    3)."""
    return isinstance(w_head, Int8Weight) or not w_head.requires_grad


# ---------------------------------------------------------------------------
# stage 1 / SFT
# ---------------------------------------------------------------------------

def _row_chunk(batch: MultimodalBatch, i: int, rows: int,
               rows_per_sample: int) -> MultimodalBatch:
    """Rows [i*rows, (i+1)*rows) of the batch.  image_pos indexes the
    batch-global flat media table (the collator adds sample_row *
    rows_per_sample), so the chunk's entries are re-offset to its own (and
    kept >= 0 on text slots, which the image mask leaves unread)."""
    sl = slice(i * rows, (i + 1) * rows)

    def r(x):
        return None if x is None else x[sl]

    return batch._replace(
        input_ids=r(batch.input_ids), segment_ids=r(batch.segment_ids),
        image_mask=r(batch.image_mask),
        image_pos=(batch.image_pos[sl]
                   - i * rows * rows_per_sample).clamp_min(0),
        pixels=r(batch.pixels), pixel_valid=r(batch.pixel_valid),
        labels=r(batch.labels), positions=r(batch.positions),
        video_pixels=r(batch.video_pixels), video_valid=r(batch.video_valid))


def _ce_token_count(labels: torch.Tensor, ignore_index: int = -100):
    """RAW supervised-token count of a chunk (next-token shift).  Not
    floored: an empty chunk's CE is 0 with zero gradient, so its weight
    must be 0 — flooring at 1 would scale every gradient by N/(N+n_empty)
    against the one-shot step."""
    return (labels[:, 1:] != ignore_index).float().sum()


def make_pretrain_step(cfg: LlavaConfig, tcfg: TrainConfig,
                       lora_cfg=None) -> Callable:
    """step(state, batch) -> (state, metrics): next-token CE (+ router aux
    * coef for MoE).  metrics: loss, loss/lm, num_tokens, loss/moe_balance
    (MoE), grad_norm.

    With `grad_row_chunks` = n > 1 dividing B, the batch runs as n row
    chunks, each forward + backward in turn, so activations are held for
    one chunk only; each chunk's CE is weighted by its token share and the
    aux loss by coef / n, so the summed gradients are the one-shot ones.
    An MoE decoder keeps one chunk unless gating groups
    (`moe_gating_group_size`) tile the chunk: global gating pools capacity
    over the whole batch, which chunks would not reproduce."""
    moe_on = cfg.llm.is_moe and tcfg.moe_loss_enable
    coef = cfg.llm.router_aux_loss_coef if moe_on else 0.0
    rows_per_sample = cfg.max_images * cfg.num_image_tokens \
        + cfg.num_video_tokens
    dtype = _DTYPES[tcfg.compute_dtype]

    def ce_forward(model, batch: MultimodalBatch, count_reduce=None):
        out, w_head = _student_forward(model, cfg, batch, tcfg)
        with trace.span("train.loss", device=True):
            ce = softmax_cross_entropy(out.hidden, w_head, batch.labels,
                                       chunk=tcfg.vocab_chunk,
                                       stream_dh=_head_frozen(w_head),
                                       count_reduce=count_reduce)
        return out, ce

    def one_shot(model, batch: MultimodalBatch) -> Metrics:
        pctx = parallel_context()
        out, ce = ce_forward(model, batch, _count_reduce(pctx))
        loss = ce.loss
        metrics = {"loss/lm": ce.loss, "num_tokens": ce.num_tokens}
        if moe_on:
            loss = loss + coef * _once(out.aux_loss, pctx)
            metrics["loss/moe_balance"] = out.aux_loss
        metrics["loss"] = loss
        with trace.span("train.backward", device=True):
            loss.backward()
        return metrics

    def chunked(model, batch: MultimodalBatch, n_ck: int) -> Metrics:
        rows = batch.input_ids.shape[0] // n_ck
        chunks = [_row_chunk(batch, i, rows, rows_per_sample)
                  for i in range(n_ck)]
        pctx = parallel_context()
        ntok = [_ce_token_count(cb.labels) for cb in chunks]
        n_total = torch.stack(ntok).sum()
        if pctx is not None:
            n_total = pctx.all_sum(n_total)
        n_total = n_total.clamp_min(1.0)
        zero = torch.zeros((), device=batch.input_ids.device)
        loss_sum, ce_sum, aux_sum = zero, zero, zero
        for cb, n_c in zip(chunks, ntok):
            out, ce = ce_forward(model, cb)
            aux = out.aux_loss if cfg.llm.is_moe else zero
            term = (n_c / n_total) * ce.loss + (coef / n_ck) * _once(aux,
                                                                    pctx)
            with trace.span("train.backward", device=True):
                term.backward()
            loss_sum = loss_sum + term.detach()
            ce_sum = ce_sum + ce.loss.detach() * n_c
            aux_sum = aux_sum + aux.detach()
        metrics = {"loss/lm": ce_sum / n_total, "num_tokens": n_total,
                   "loss": loss_sum}
        if moe_on:
            metrics["loss/moe_balance"] = aux_sum / n_ck
        return metrics

    def step(state: TrainState, batch: MultimodalBatch):
        with trace.span("train.step", id=state.step, device=True):
            model = state.model
            _stop_frozen(model, tcfg, lora_cfg)
            _clear_grads(state)
            b, t = batch.input_ids.shape
            n_ck = tcfg.grad_row_chunks
            n_ck = n_ck if (n_ck > 1 and b % n_ck == 0) else 1
            if n_ck > 1 and cfg.llm.is_moe:
                group = cfg.llm.moe_gating_group_size
                if not (group > 0 and ((b // n_ck) * t) % group == 0):
                    n_ck = 1
            with lora_merged(model, state.lora, lora_cfg), \
                    _cast_tree(model, dtype):
                metrics = (chunked(model, batch, n_ck) if n_ck > 1
                           else one_shot(model, batch))
            return _apply_update(state, _world_metrics(
                metrics, parallel_context()), cfg)

    return step


# ---------------------------------------------------------------------------
# stage 3: preference (DPO) distillation
# ---------------------------------------------------------------------------

def _concat_pair_batch(d: Dict[str, Any], device="cuda") -> MultimodalBatch:
    """Stack chosen + rejected into one [2B] batch sharing the images.

    The pixels stay [B, M, ...]: both halves carry the SAME image_pos rows
    into the flattened [B*M*N] feature table, so each image is encoded
    once per step."""
    chosen = batch_from_arrays(d, "chosen_", device=device)
    rejected = batch_from_arrays(d, "rejected_", device=device)

    def cat(a, b_):
        return torch.cat([a, b_], dim=0)

    return MultimodalBatch(
        input_ids=cat(chosen.input_ids, rejected.input_ids),
        segment_ids=cat(chosen.segment_ids, rejected.segment_ids),
        image_mask=cat(chosen.image_mask, rejected.image_mask),
        image_pos=cat(chosen.image_pos, rejected.image_pos),
        pixels=chosen.pixels, pixel_valid=chosen.pixel_valid,
        labels=cat(chosen.labels, rejected.labels))


def make_dpo_step(policy_cfg: LlavaConfig, ref_cfg: LlavaConfig,
                  tcfg: TrainConfig, lora_cfg=None) -> Callable:
    """step(state, ref, batch_dict) -> (state, metrics).

    The policy runs chosen + rejected as one [2B] forward and backward, the
    reference model (a Llava module; built with `vision=False` it takes the
    policy's tower features) as one [2B] forward under no_grad; then the
    sigmoid | hinge | ipo | kto_pair loss (+ router aux * coef for an MoE
    policy).  metrics: loss, loss/dpo, rewards/{chosen,rejected,accuracies,
    margins}, logps/{chosen,rejected}, loss/moe_balance (MoE), grad_norm."""
    share_tower = _can_share_tower(tcfg, policy_cfg, ref_cfg)
    dtype = _DTYPES[tcfg.compute_dtype]

    def paired_forward(model, cfg, batch2b, train, tower_feats):
        cb = batch2b._replace(pixels=batch2b.pixels.to(dtype))
        out = model(cb, cfg=cfg, train=train, remat=tcfg.remat and train,
                    attn_impl=tcfg.attn_impl, tower_feats=tower_feats)
        w = llava.lm_head_weight(model, cfg)
        logps = sequence_log_prob(out.hidden, w, batch2b.labels,
                                  chunk=tcfg.vocab_chunk,
                                  stream_dh=train and _head_frozen(w))
        b2 = logps.shape[0]
        return logps[: b2 // 2], logps[b2 // 2:], out

    def loss_fn(model, ref, batch2b, pctx):
        # the policy's forward runs the frozen tower; a reference without
        # its own takes the features
        pc, pr, pol_out = paired_forward(model, policy_cfg, batch2b, True,
                                         None)
        with torch.no_grad():
            rc, rr, _ = paired_forward(
                ref, ref_cfg, batch2b, False,
                pol_out.tower_feats if share_tower else None)
        if pctx is not None:
            # the world's pairs, rank-major as the single-process batch
            pc, pr, rc, rr = (pctx.gather_values(t) for t in (pc, pr, rc, rr))
        out = dpo_loss(pc, pr, rc, rr, beta=tcfg.dpo_beta,
                       label_smoothing=tcfg.dpo_label_smoothing,
                       loss_type=tcfg.dpo_loss_type,
                       reference_free=tcfg.reference_free)
        loss = out.losses.mean()
        acc = (out.chosen_rewards > out.rejected_rewards).float()
        metrics: Metrics = {
            "loss/dpo": loss,
            "rewards/chosen": out.chosen_rewards.mean(),
            "rewards/rejected": out.rejected_rewards.mean(),
            "rewards/accuracies": acc.mean(),
            "rewards/margins": (out.chosen_rewards
                                - out.rejected_rewards).mean(),
            "logps/chosen": pc.mean(),
            "logps/rejected": pr.mean(),
        }
        if policy_cfg.llm.is_moe and tcfg.moe_loss_enable:
            loss = loss + policy_cfg.llm.router_aux_loss_coef * pol_out.aux_loss
            metrics["loss/moe_balance"] = pol_out.aux_loss
        metrics["loss"] = loss
        # every rank holds the world's loss: each counts it once
        return _once(loss, pctx), metrics

    def step(state: TrainState, ref: nn.Module, batch_dict: Dict[str, Any]):
        with trace.span("train.step", id=state.step, device=True):
            model = state.model
            _stop_frozen(model, tcfg, lora_cfg)
            _clear_grads(state)
            device = next(model.parameters()).device
            batch2b = _concat_pair_batch(batch_dict, device=device)
            pctx = parallel_context()
            segments = (pctx.token_segments(2) if pctx is not None
                        else contextlib.nullcontext())
            with lora_merged(model, state.lora, lora_cfg), \
                    _cast_tree(model, dtype), _cast_tree(ref, dtype), \
                    segments:
                loss, metrics = loss_fn(model, ref, batch2b, pctx)
                with trace.span("train.backward", device=True):
                    loss.backward()
            return _apply_update(state, metrics, policy_cfg)

    return step
