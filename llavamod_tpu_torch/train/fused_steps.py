"""Fused backward+update align step (port of
llavamod_tpu/train/fused_steps.py).

The standard align step (train/steps.py `make_align_step`) holds the whole
trainable-gradient set before the optimizer update: 4.07 GB of bf16 for the
record FFN + router train set (2.035 B parameters), beside AdamW's two
moments.  This step never holds more than one layer's gradients:

  forward:  the frozen teacher under no_grad (in batch-row chunks); the
            head section (embedding, projector, image splice) with autograd
            on its trainable leaves only; then every student layer under
            no_grad, saving each layer's INPUT (`fused_remat='repeat'`);
  tail:     final norm + the vocab-chunked KD(+CE) loss, normalized per
            microbatch and averaged; `torch.autograd.grad` gives
            d loss / d x_L and the gradients of a trainable final norm or
            head;
  backward: layer by layer, last to first: recompute the layer's forward
            from its saved input under autograd, take the gradients of its
            trainable parameters and of its input, apply the Adafactor
            update to that layer in place (train/adafactor.py), free the
            gradients and pass d x down;
  head:     the head section's gradients update the projector (projector
            learning rate) and a trainable embedding; a tied head's tail
            gradient is added to the embedding's before its one update.

Every recomputation reads its own layer's parameters before their update,
so the step equals grad-then-update (`make_align_step` + Adafactor), with
the update rule's blocks one parameter tensor each.  `fused_remat =
'save_all'` keeps each layer's autograd graph from the forward instead of
recomputing; 'save_dots' keeps the matmul outputs and recomputes the rest
(the policy of decoder `remat_policy='dots'`).

Gradient accumulation (grad_accum_steps = M > 1) is in-batch: the caller
folds the M microbatches into the batch axis (train/loader.py
`fold_microbatches`) and one call applies the update of their mean
gradient, as optax.MultiSteps would over M calls: the tail loss is
normalized per microbatch, then averaged.  The backward then recomputes
each layer one microbatch at a time (chunks of `fused_bwd_microbatches`),
which is exact only when MoE routing factors over microbatches: gating
groups that tile the microbatch.  With global gating the step warns and
takes the folded backward, whose routing pools capacity over the folded
tokens.  The forward runs in chunks of whole microbatches
(`fused_fwd_chunks`) under the same condition, and the dense teacher in
row chunks (`fused_teacher_chunks`); -1 picks the JAX package's measured
defaults.

Under a parallel context (one process per card, both models sharded by
parallel/sharding.py `shard_params`) the step is its rank's share of the
single-process step on the world's rows, as train/steps.py's are, and
drives FSDP2 itself (`hand_driven`: its hooks neither reshard nor
reduce): each student layer and its expert group are gathered once for the
forward's chunks and once for every recompute of the backward, each
teacher layer once for its row chunks, the student's root unit and
projector for the step, the teacher's root for its embed and its final
norm (through the tail when its head is a float parameter).  A layer's
gradients, summed over the recompute's chunks in the compute dtype, are
reduced in f32 to the rank's shard (`reduce_to_shard`: over tensor first
for a replicated decoder leaf under sequence parallelism, then over data x
fsdp x expert, or data x fsdp for an expert rank's own experts) before
that layer's Adafactor update, and freed.  Each microbatch's loss divides
by the world's tokens of that microbatch; the router aux term counts once
over the rows group; grad_norm is the world's, each replicated leaf
counted once (`Optimizer.norm_weights`); a chunk of several folded
microbatches gates the world's tokens microbatch-major, as the single
process folds them.  Every rank makes the same calls: the chunk counts
depend on the batch shape and the world's rows only.

Refused (ValueError, before the first step): an optimizer other than
Adafactor, LoRA, a trainable parameter outside the decoder layers,
projector, embedding, final norm and head (the vision tower), a trainable
head with `student_head_quant` (an int8 head takes no gradient), and a
trainable parameter not stored in the compute dtype (updates are in
place).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llava import LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.ops.losses import kd_align_loss, kd_ce_align_loss
from llavamod_tpu_torch.parallel.collectives import (
    column_in,
    current as parallel_context,
    split_seq,
    tensor_size,
)
from llavamod_tpu_torch.parallel.sharding import (
    gathered,
    hand_driven,
    is_sharded,
    local_tensor,
    reduce_to_shard,
)
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import (
    Optimizer,
    TrainState,
    apply_trainable_mask,
)
from llavamod_tpu_torch.train.steps import (
    _DTYPES,
    _can_share_tower,
    _cast_tree,
    _count_reduce,
    _once,
    _shared_tower_feats,
    _world_metrics,
)

Metrics = Dict[str, torch.Tensor]

_HEAD_SECTION = ("projector.", "video_projector.", "llm.embed.")
_OUTER = _HEAD_SECTION + ("llm.lm_head.", "llm.final_norm.")
_FUSED_REMAT = ("repeat", "save_dots", "save_all")


def _head_name(model) -> str:
    """The parameter the loss reads as the student head: an explicit
    lm_head wins, as `decoder.lm_head_weight` decides."""
    return ("llm.lm_head.weight" if hasattr(model.llm, "lm_head")
            else "llm.embed.embedding")


def _check_supported(model, tcfg: TrainConfig, mask: Dict[str, bool]) -> None:
    if tcfg.optimizer != "adafactor":
        raise ValueError("the fused backward applies per-layer Adafactor "
                         "updates; set optimizer='adafactor'")
    if tcfg.fused_remat not in _FUSED_REMAT:
        raise ValueError(f"fused_remat must be one of {_FUSED_REMAT}; got "
                         f"{tcfg.fused_remat!r}")
    outside = [n for n, m in mask.items()
               if m and not (n.startswith("llm.layers.")
                             or n.startswith(_OUTER))]
    if outside:
        raise ValueError(f"the fused align step cannot update {outside[:4]}: "
                         f"only decoder-layer, (video) projector, embed, "
                         f"lm_head and final_norm parameters")
    if tcfg.student_head_quant and mask.get(_head_name(model), False):
        raise ValueError("student_head_quant with a TRAINABLE head: the int8 "
                         "head takes no gradient (ops/losses.py); unfreeze "
                         "the head only with a float head")
    dtype = _DTYPES[tcfg.compute_dtype]
    named = dict(model.named_parameters())
    wrong = [f"{n} {named[n].dtype}" for n, m in mask.items()
             if m and named[n].dtype != dtype]
    if wrong:
        raise ValueError(f"fused updates are in place: trainable parameters "
                         f"must be stored in the compute dtype "
                         f"({tcfg.compute_dtype}); got {wrong[:4]}")


def init_fused_state(model, student_cfg: LlavaConfig, tcfg: TrainConfig,
                     lora_cfg=None, pctx=None) -> TrainState:
    """TrainState for `make_fused_align_step`: the train set frozen as
    `TrainState.create` does, and one `Optimizer` of Adafactor groups (no
    MultiSteps: accumulation is folded into the batch), whose state is
    per parameter tensor, so `state.opt.state_dict()` checkpoints it.  On
    a model sharded on `pctx`'s mesh the state is the rank's shards."""
    if lora_cfg is not None:
        raise ValueError("the fused align step does not support LoRA")
    mask = apply_trainable_mask(model, tcfg)
    _check_supported(model, tcfg, mask)
    return TrainState(0, model, Optimizer(model, tcfg, pctx=pctx))


def _experts(layer):
    """The stacked-expert group of an MoE layer (its own FSDP2 unit)."""
    return layer.mlp.experts if getattr(layer, "is_moe", False) else None


def _grads(outputs: Sequence[torch.Tensor],
           cotangents: Sequence[torch.Tensor],
           inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """d outputs / d inputs; an input the outputs do not reach gets zeros."""
    if not inputs:
        return []
    got = torch.autograd.grad(list(outputs), inputs, list(cotangents),
                              allow_unused=True)
    return [g if g is not None else torch.zeros_like(x)
            for g, x in zip(got, inputs)]


def make_fused_align_step(student_cfg: LlavaConfig, teacher_cfg: LlavaConfig,
                          tcfg: TrainConfig) -> Callable:
    """step(state, teacher, batch) -> (state, metrics), the contract of
    `make_align_step`; `state` comes from `init_fused_state`.  With
    grad_accum_steps = M the batch is M folded microbatches and one call
    is one optimizer update.  metrics: loss, loss/align, loss/lm (kd_lm),
    num_tokens (summed over the microbatches), loss/moe_balance (MoE),
    grad_norm (of the update's mean gradient)."""
    cfg = student_cfg
    vocab_limit = tcfg.kd_vocab_limit or min(student_cfg.llm.vocab_size,
                                             teacher_cfg.llm.vocab_size)
    share_tower = _can_share_tower(tcfg, student_cfg, teacher_cfg)
    dtype = _DTYPES[tcfg.compute_dtype]
    coef = (cfg.llm.router_aux_loss_coef
            if (cfg.llm.is_moe and tcfg.moe_loss_enable) else 0.0)
    save_residuals = tcfg.fused_remat != "repeat"
    loss_kw = dict(vocab_limit=vocab_limit,
                   distill_all_tokens=tcfg.distill_all_tokens,
                   chunk=tcfg.vocab_chunk, int8_dh=tcfg.kd_int8_dh,
                   stream_dh=tcfg.kd_stream_dh)

    def chunks(t: Optional[torch.Tensor], n: int):
        return t.chunk(n) if t is not None else (None,) * n

    def segments(pctx, mbs: int):
        """Under a context, a chunk of `mbs` folded microbatches gates the
        world's tokens microbatch-major, as the single process folds them
        (parallel/collectives.py `token_segments`)."""
        if pctx is None or mbs <= 1:
            return contextlib.nullcontext()
        return pctx.token_segments(mbs)

    def teacher_forward(teacher, cbatch: MultimodalBatch, tower, positions,
                        n_chunks: int, pctx, hold):
        """Frozen teacher hidden states and head weight, in n_chunks batch-
        row chunks after one folded embed + splice (exact for a dense
        teacher: rows never interact), layer by layer: each layer (and its
        expert group) gathered once for every chunk.  The root unit is
        gathered for the embed and again for the final norm; a float head
        keeps it gathered (held by `hold`) through the tail."""
        tllm = teacher_cfg.llm
        tp = tensor_size(pctx)
        seq = bool(tllm.seq_shard_activations) and tp > 1
        accum = max(1, tcfg.grad_accum_steps)
        with torch.no_grad():
            with gathered(teacher, teacher.projector,
                          getattr(teacher, "vision", None),
                          getattr(teacher, "video_projector", None)):
                emb = llava.multimodal_embed(teacher, teacher_cfg, cbatch,
                                             tower)
            xs = list(emb.chunk(n_chunks))
            del emb
            ps = positions.chunk(n_chunks)
            ss = chunks(cbatch.segment_ids, n_chunks)
            if seq:
                xs = [split_seq(x, pctx) for x in xs]
            for i, layer in enumerate(teacher.llm.layers):
                with gathered(layer, _experts(layer)), \
                        segments(pctx, accum // n_chunks):
                    xs = [decoder.layer_forward(tllm, layer, x, p, sg, i,
                                                None, False,
                                                tcfg.attn_impl)[0]
                          for x, p, sg in zip(xs, ps, ss)]
            root = contextlib.ExitStack()
            root.enter_context(gathered(teacher))
            hidden = []
            for x in xs:
                h = decoder._norm(tllm, teacher.llm.final_norm, x)
                hidden.append(column_in(h, pctx, seq) if tp > 1 else h)
            w_t = llava.lm_head_weight(teacher, teacher_cfg)
            if isinstance(w_t, Int8Weight):
                root.close()        # a buffer: FSDP2 leaves it whole
            else:
                hold.enter_context(root)
            return torch.cat(hidden) if n_chunks > 1 else hidden[0], w_t

    def layer_fwd(layer, i, x, positions, seg, pctx, mbs: int,
                  n_chunks: int = 1):
        """(x_out, aux) of decoder layer i, in n_chunks row chunks of
        whole microbatches, `mbs` of them in each (aux averaged: per-group
        normalization makes the mean of the chunks' aux the folded aux)."""
        outs, auxs = [], []
        for xc, pc, sc in zip(x.chunk(n_chunks), positions.chunk(n_chunks),
                              chunks(seg, n_chunks)):
            with segments(pctx, mbs):
                xo, aux, _ = decoder.layer_forward(cfg.llm, layer, xc, pc, sc,
                                                   i, None, True,
                                                   tcfg.attn_impl)
            outs.append(xo)
            auxs.append(aux)
        if n_chunks == 1:
            return outs[0], auxs[0]
        return torch.cat(outs), torch.stack(auxs).mean()

    def one_microbatch_loss(hidden_m, labels_m, h_t_m, w_s, w_t, pctx):
        """(kd, ce, tokens) of one microbatch, normalized by ITS tokens
        (the world's, under a context)."""
        kw = dict(loss_kw, count_reduce=_count_reduce(pctx))
        if tcfg.align_loss_type == "kd_lm":
            out = kd_ce_align_loss(hidden_m, w_s, h_t_m, w_t, labels_m, **kw)
            return out.kd_loss, out.ce_loss, out.kd_tokens
        out = kd_align_loss(hidden_m, w_s, h_t_m, w_t, labels_m, **kw)
        return out.loss, torch.zeros_like(out.loss), out.num_tokens

    def step(state: TrainState, teacher, batch: MultimodalBatch):
        pctx = parallel_context()
        model, opt = state.model, state.opt
        mask = apply_trainable_mask(model, tcfg)
        trainable = [n for n, m in mask.items() if m]
        sharded = pctx is not None and is_sharded(model)
        if sharded:
            hand_driven(model)
            hand_driven(teacher)
        rows = pctx.rows if pctx is not None else 1
        tp = tensor_size(pctx)
        seq = bool(cfg.llm.seq_shard_activations) and tp > 1
        splits = getattr(model, "tensor_split", {})
        b, t = batch.input_ids.shape
        dev = batch.input_ids.device
        positions = (batch.positions if batch.positions is not None
                     else torch.arange(t, device=dev)[None, :].expand(b, t))
        seg = batch.segment_ids

        accum = max(1, tcfg.grad_accum_steps)
        if b % accum:
            raise ValueError(
                f"fused accumulation folds microbatches into the batch axis: "
                f"batch rows ({b}) must be grad_accum_steps ({accum}) x the "
                f"per-microbatch size (train/loader.py fold_microbatches)")
        # The microbatched backward differentiates the folded forward only
        # if MoE routing factors over microbatches: gating groups that tile
        # the microbatch (the [B*T] flatten is row-major) of the world's
        # rows.  Global gating pools capacity, drops and aux over the
        # folded tokens.
        mb_gating_exact = True
        if cfg.llm.is_moe and accum > 1:
            group = cfg.llm.moe_gating_group_size
            mb_tokens = (b // accum) * rows * t
            mb_gating_exact = group > 0 and mb_tokens % group == 0
            if not mb_gating_exact:
                warnings.warn(
                    "fused accumulation with MoE + global gating "
                    f"(moe_gating_group_size={group}, microbatch tokens "
                    f"{mb_tokens}): routing pools capacity across the "
                    "folded microbatches, so the backward uses the exact "
                    "folded recompute (higher residual memory) and the "
                    "update is NOT equal to grad_accum_steps separate "
                    "calls.  Set moe_gating_group_size to a divisor of the "
                    "microbatch token count for exact accumulation "
                    "semantics.", stacklevel=2)

        n_tc = tcfg.fused_teacher_chunks
        if n_tc < 0:
            n_tc = b if accum > 1 else 1    # JAX auto: 1-row chunks
        if teacher_cfg.llm.is_moe or b % max(1, n_tc):
            n_tc = 1
        n_tc = max(1, n_tc)
        fwd_chunks = tcfg.fused_fwd_chunks
        if fwd_chunks < 0:
            fwd_chunks = accum if accum > 1 else 1   # one per microbatch
        rows_ok = (fwd_chunks > 1 and b % fwd_chunks == 0
                   and (b // fwd_chunks) % max(1, b // accum) == 0)
        n_fwd = (fwd_chunks if rows_ok and mb_gating_exact
                 and not save_residuals else 1)
        bwd_mb = max(1, tcfg.fused_bwd_microbatches)
        if accum % bwd_mb:
            bwd_mb = 1
        n_bwd = accum // bwd_mb if accum > 1 and mb_gating_exact else 1

        layers = model.llm.layers
        layer_names = [[n for n in trainable
                        if n.startswith(f"llm.layers.{i}.")]
                       for i in range(len(layers))]
        head_names = [n for n in trainable if n.startswith(_HEAD_SECTION)]
        head_name = _head_name(model)
        tail_names = [n for n in trainable
                      if n.startswith("llm.final_norm.") or n == head_name]
        # d x is asked of layer i when something below it trains
        need_dx = [bool(head_names or any(layer_names[:i]))
                   for i in range(len(layers))]
        # a layer's router aux counts once over the rows group
        aux_cot = coef / rows

        # --- backward, last layer to first, updating as it goes ---
        gn_sq = torch.zeros((), dtype=torch.float32, device=dev)
        sharded_params = dict(model.named_parameters()) if sharded else {}

        def apply(names, dps):
            """The Adafactor update of each parameter from its gradient:
            under a context first reduced to the rank's shard
            (parallel/sharding.py `reduce_to_shard`)."""
            nonlocal gn_sq
            for n, dp in zip(names, dps):
                if sharded:
                    dp = reduce_to_shard(
                        dp, sharded_params[n], n, pctx,
                        tensor_partial=seq and n.startswith("llm.")
                        and n not in splits)
                    gn_sq = gn_sq + (local_tensor(dp).float().pow(2).sum()
                                     * opt.norm_weights[n])
                else:
                    gn_sq = gn_sq + dp.float().pow(2).sum()
                opt.update_leaf(n, dp)

        with _cast_tree(model, dtype), _cast_tree(teacher, dtype), \
                contextlib.ExitStack() as hold:
            cbatch = batch._replace(pixels=batch.pixels.to(dtype))
            # the student's root unit (embedding, final norm, head) and
            # projector stay gathered for the step
            hold.enter_context(gathered(
                model, model.projector,
                getattr(model, "video_projector", None)))
            # --- head section, autograd on its trainable leaves only ---
            with gathered(getattr(model, "vision", None)):
                tower = (_shared_tower_feats(model, cfg, cbatch, tcfg)
                         if share_tower else None)
                with torch.enable_grad():
                    x0 = llava.multimodal_embed(model, cfg, cbatch, tower)
                    if seq:
                        x0 = split_seq(x0, pctx)
            h_t, w_t = teacher_forward(teacher, cbatch, tower, positions,
                                       n_tc, pctx, hold)
            named = dict(model.named_parameters())   # the gathered root

            # --- forward over the layers ---
            saved = []
            aux_total = torch.zeros((), dtype=torch.float32, device=dev)
            x = x0.detach()
            for i, layer in enumerate(layers):
                units = (layer, _experts(layer))
                if save_residuals:
                    # the layer's graph reads its gathered weights: it
                    # stays gathered until its backward
                    held = contextlib.ExitStack()
                    held.enter_context(gathered(*units))
                    x_in = x.requires_grad_(need_dx[i])
                    with torch.enable_grad():
                        if tcfg.fused_remat == "save_dots":
                            x_out, aux = checkpoint(
                                layer_fwd, layer, i, x_in, positions, seg,
                                pctx, accum, use_reentrant=False,
                                context_fn=decoder.dots_saved_context)
                        else:
                            x_out, aux = layer_fwd(layer, i, x_in, positions,
                                                   seg, pctx, accum)
                    saved.append((x_in, x_out, aux, held))
                    x = x_out.detach()
                else:
                    saved.append(x)
                    with torch.no_grad(), gathered(*units):
                        x, aux = layer_fwd(layer, i, x, positions, seg, pctx,
                                           accum // n_fwd, n_fwd)
                aux_total = aux_total + aux.detach()

            # --- tail: final norm + per-microbatch chunked loss ---
            w_s = llava.lm_head_weight(model, cfg)
            if tcfg.student_head_quant and not isinstance(w_s, Int8Weight):
                with torch.no_grad():
                    w_s = decoder.quantize_head_int8(w_s)
            x_last = x.detach().requires_grad_()
            with torch.enable_grad():
                hidden = decoder._norm(cfg.llm, model.llm.final_norm, x_last)
                if tp > 1:
                    hidden = column_in(hidden, pctx, seq)
                kd, ce, ntok = zip(*[
                    one_microbatch_loss(hm, lm, tm, w_s, w_t, pctx)
                    for hm, lm, tm in zip(hidden.chunk(accum),
                                          batch.labels.chunk(accum),
                                          h_t.chunk(accum))])
                kd_loss = torch.stack(kd).mean()
                ce_loss = torch.stack(ce).mean()
                loss_main = kd_loss + ce_loss
                g, *d_tail = _grads([loss_main], [torch.ones_like(loss_main)],
                                    [x_last] + [named[n] for n in tail_names])
            del hidden, h_t, w_t
            grads = dict(zip(tail_names, d_tail))

            def layer_grads(out, aux, params, x_in, g_out, aux_c):
                outputs, cots = [out], [g_out]
                if aux_c and aux.requires_grad:
                    outputs.append(aux)
                    cots.append(torch.full_like(aux, aux_c))
                inputs = params + ([x_in] if x_in is not None else [])
                got = _grads(outputs, cots, inputs)
                return got[:len(params)], (got[-1] if x_in is not None
                                           else None)

            for i in reversed(range(len(layers))):
                layer, names = layers[i], layer_names[i]
                if not names and not need_dx[i]:
                    break            # nothing at or below layer i trains
                with gathered(layer, _experts(layer)):
                    lnamed = dict(layer.named_parameters(
                        prefix=f"llm.layers.{i}"))
                    params = [lnamed[n] for n in names]
                    if save_residuals:
                        x_in, x_out, aux, held = saved[i]
                        dps, dx = layer_grads(x_out, aux, params,
                                              x_in if need_dx[i] else None, g,
                                              aux_cot)
                        del x_in, x_out, aux
                        held.close()
                    else:
                        dps, dxs = None, []
                        for xm, gm, pm, sm in zip(saved[i].chunk(n_bwd),
                                                  g.chunk(n_bwd),
                                                  positions.chunk(n_bwd),
                                                  chunks(seg, n_bwd)):
                            xm = xm.detach().requires_grad_(need_dx[i])
                            with torch.enable_grad():
                                out, aux = layer_fwd(layer, i, xm, pm, sm,
                                                     pctx, accum // n_bwd)
                                dp, dxm = layer_grads(
                                    out, aux, params,
                                    xm if need_dx[i] else None, gm,
                                    aux_cot / n_bwd)
                            if dps is None:
                                dps = dp
                            else:
                                for a, c in zip(dps, dp):
                                    a.add_(c)
                            dxs.append(dxm)
                            del out, aux, dp
                        dx = torch.cat(dxs) if need_dx[i] else None
                    del params, lnamed
                saved[i] = None
                apply(names, dps)
                del dps
                g = dx

            # --- head section: projector and embedding; a tied head's
            # tail gradient joins the embedding's ---
            if head_names and x0.requires_grad:
                d_head = _grads([x0], [g], [named[n] for n in head_names])
                for n, d in zip(head_names, d_head):
                    grads[n] = grads[n] + d if n in grads else d
            del x0, g
            # the align losses never read a head bias: its gradient is zero
            rest = [n for n in trainable if n.startswith(_OUTER)]
            apply(rest, [grads.pop(n) if n in grads
                         else torch.zeros_like(named[n]) for n in rest])
            del named
            opt.advance()

        if sharded:
            torch.distributed.all_reduce(gn_sq)
        metrics: Metrics = {
            "loss": loss_main.detach() + coef * _once(aux_total, pctx),
            "loss/align": kd_loss.detach(),
            "num_tokens": torch.stack(ntok).sum(),
            "grad_norm": torch.sqrt(gn_sq),
        }
        if tcfg.align_loss_type == "kd_lm":
            metrics["loss/lm"] = ce_loss.detach()
        if coef:
            metrics["loss/moe_balance"] = aux_total
        return (state._replace(step=state.step + 1),
                _world_metrics(metrics, pctx))

    return step
