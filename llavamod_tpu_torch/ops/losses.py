"""Training losses over vocab chunks (port of llavamod_tpu/ops/losses.py).

The LM head product, the softmax statistics and the loss contraction run in
a loop over vocab chunks inside `torch.autograd.Function`s, so no
[tokens, vocab] logit tensor is ever held: the forward keeps running
(max, sum) statistics per row, and the backward recomputes each chunk's
logits and folds its cotangent into dL/dh (and dL/dW when the head trains).
Each chunk's logits are an f32-output product of the bf16 operands
(ops/matmul.py), as the JAX `preferred_element_type=f32`; the cotangent is
cast to the head's dtype before ds.W and to the hidden dtype before ds^T.h,
with f32 accumulation, as in the JAX backward.

  * `chunked_lse_and_gather` — (logsumexp, label logit) per row (CE);
  * `chunked_kd_cross_entropy` — sum_n w_n * -sum_v p_t(v) logp_s(v) (KD);
  * `chunked_kd_ce` — both in one pass (the kd_lm recipe);
  * `softmax_cross_entropy`, `kd_align_loss`, `kd_ce_align_loss` — the
    token-mean losses the training steps call;
  * `sequence_log_prob`, `dpo_loss` — the preference (stage-3) losses.

Every head may be an `Int8Weight` (per-vocab-row scales), the teacher's
and the student's alike: its chunk logits are int8 products of the hidden
rows, quantized once per call, rescaled in f32 (JAX `_prep_head_stream`).
An int8 head is frozen by construction and takes no dW.  Its dh comes
through the chunk dequantized to bf16 (exact with respect to the quantized
forward), or with `int8_dh` as the straight-through int8 product of the
row-quantized cotangent (JAX `_student_dh_and_dw`).  With `stream_dh` and
an int8 student head, the forward also streams the probability-weighted
head averages p@W (running-max rescaled, JAX `_kd_fwd_streamed`,
`_kdce_fwd_streamed`, `_lse_gather_fwd_streamed`) and the backward is
elementwise; the choice follows the head the Function is handed, never a
config path.  With a float head, `stream_dh` changes nothing: the JAX
streamed backward is an exact reordering of the two-pass one that runs
here, and whether dW is formed is decided by the head
(`ctx.needs_input_grad`).

Vocab-parallel under a tensor split (parallel/collectives.py): each rank's
head is its slice of the vocab rows, and it scans the chunks of the global
chunk grid that fall in its rows (a rank's last chunk may be partial, and
`vocab_limit` cuts where it falls).  The rows' running max and sum, the KD
numerator and the CE label logit (from the rank that owns it) are then
reduced over the tensor group, so every rank holds the single-process
logsumexp and loss; the backward uses the global logsumexp, and each
rank's dL/dh is its partial sum over its vocab rows (the decoder's final
hidden reduces it, models/llm/decoder.py `forward`).  The streamed p@W of
an int8 head stays each rank's partial sum, rescaled to the global
statistics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.ops.int8 import act_quant_rows, int8_matmul
from llavamod_tpu_torch.ops.matmul import matmul_f32_out
from llavamod_tpu_torch.parallel.collectives import (
    current as parallel_context,
    tensor_max,
    tensor_size,
    tensor_sum,
)

DEFAULT_CHUNK = 8192


def _head_rows(w) -> int:
    """Vocab rows of a head (a [V, D] tensor or an Int8Weight)."""
    return w.w_int8.shape[0] if isinstance(w, Int8Weight) else w.shape[0]


def _vocab_rows(w) -> int:
    """Vocab rows of the whole head whose rank slice `w` is."""
    return _head_rows(w) * tensor_size(parallel_context())


def _detach(w):
    return w if isinstance(w, Int8Weight) else w.detach()


class _Vocab:
    """The rank's vocab rows [lo, lo + rows) of a head (all of them in one
    process) and its chunks: the global grid of `chunk` columns below
    `vocab_limit`, cut to those rows, as local (c0, c1)."""

    def __init__(self, w, vocab_limit: int, chunk: int, pctx):
        self.pctx = pctx if tensor_size(pctx) > 1 else None
        self.rows = _head_rows(w)
        self.lo = self.pctx.tensor_rank * self.rows if self.pctx else 0
        self.limit, self.chunk = vocab_limit, chunk

    def chunks(self):
        hi = min(self.lo + self.rows, self.limit)
        for g0 in range(0, self.limit, self.chunk):
            a, b = max(g0, self.lo), min(g0 + self.chunk, hi)
            if a < b:
                yield a - self.lo, b - self.lo

    def local(self, ids):
        """(ids as local rows, -1 where another rank owns them: no chunk
        picks or one-hots those; whether the rank owns them)."""
        local = ids - self.lo
        own = (local >= 0) & (local < self.rows)
        return torch.where(own, local, -1), own

    def merge(self, *stats):
        """(max, sum) pairs over the rank's chunks -> the global (max, sum)
        pairs and each rank's rescale factor exp(m - M), two reductions
        for all pairs."""
        if self.pctx is None:
            return [(m, l, None) for m, l in stats]
        big = tensor_max(torch.stack([m for m, _ in stats]), self.pctx)
        scale = torch.exp(torch.stack([m for m, _ in stats]) - big)
        sums = torch.stack([l for _, l in stats]) * scale
        return list(zip(big, sums, scale))

    def sum(self, x):
        return x if self.pctx is None else tensor_sum(x, self.pctx)


def _normalized(acc, scale, l):
    """A streamed p@W accumulator over the global sum `l` (rescaled by the
    rank's exp(m - M) under a tensor split)."""
    if scale is None:
        return acc / l[:, None]
    return acc * (scale / l)[:, None]


def _pick(picked, s, ids, c0):
    local = ids - c0
    in_chunk = (local >= 0) & (local < s.shape[1])
    got = s.gather(1, local.clamp(0, s.shape[1] - 1)[:, None])[:, 0]
    return torch.where(in_chunk, got, picked)


def _onehot(ids, c0, n_cols):
    local = ids - c0
    cols = torch.arange(n_cols, device=ids.device)[None, :]
    return (cols == local[:, None]).float()


def _init_stats(n, device, k):
    """k pairs of (running max = -inf, running sum = 0) rows."""
    out = []
    for _ in range(k):
        out += [torch.full((n,), float("-inf"), device=device),
                torch.zeros((n,), device=device)]
    return out


class _Head:
    """One (hidden rows, head) pair, chunk by chunk: the f32 logits of a
    chunk, and the fold of an [N, C] weight matrix into [N, D]."""

    def __init__(self, h: torch.Tensor, w):
        self.w = w
        self.int8 = isinstance(w, Int8Weight)
        if self.int8:
            self.hq, self.hs = act_quant_rows(h)
        else:
            self.h = h

    def logits(self, c0: int, c1: int) -> torch.Tensor:
        if self.int8:
            w = self.w
            y = int8_matmul(self.hq, w.w_int8[c0:c1].t())
            return y.float() * self.hs * w.scale[None, c0:c1]
        return matmul_f32_out(self.h, self.w[c0:c1])

    def fold(self, e: torch.Tensor, c0: int, c1: int,
             int8_dh: bool = False) -> torch.Tensor:
        """e [N, C] f32 -> e @ W[c0:c1], f32 [N, D]: in the head's dtype
        (float head), through the chunk dequantized to bf16 (int8 head), or
        as the straight-through int8 product (int8 head, int8_dh)."""
        if not self.int8:
            w_c = self.w[c0:c1]
            return matmul_f32_out(e.to(w_c.dtype), w_c.t())
        wq, s = self.w.w_int8[c0:c1], self.w.scale[c0:c1]
        if int8_dh:
            q, qs = act_quant_rows(e * s[None, :])
            return int8_matmul(q, wq).float() * qs
        wf = wq.bfloat16() * s.bfloat16()[:, None]
        return matmul_f32_out(e.bfloat16(), wf.t())

    def rows(self, ids: torch.Tensor, own=None) -> torch.Tensor:
        """Dequantized f32 rows W[ids] of an int8 head (zero where `own` is
        False: another rank holds the row)."""
        r = self.w.w_int8[ids].float() * self.w.scale[ids][:, None]
        return r if own is None else torch.where(own[:, None], r, 0.0)


class _HeadGrads:
    """Accumulates dL/dh over the chunks and writes dL/dW chunk by chunk
    (only for a float head that takes a gradient)."""

    def __init__(self, head: _Head, h, want_dw: bool, int8_dh: bool = False):
        self.head, self.h, self.int8_dh = head, h, int8_dh
        self.dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        self.dw = (torch.zeros_like(head.w)
                   if want_dw and not head.int8 else None)

    def add(self, ds, c0, c1):
        self.dh += self.head.fold(ds, c0, c1, self.int8_dh)
        if self.dw is not None:
            self.dw[c0:c1] = matmul_f32_out(ds.to(self.h.dtype).t(),
                                            self.h.t()).to(self.dw.dtype)

    def result(self):
        return self.dh.to(self.h.dtype), self.dw


def _stash_heads(ctx, *heads):
    """Float heads go through save_for_backward (returned here); an
    Int8Weight (no gradient, not a tensor) rides on ctx."""
    ctx.int8_heads = [w if isinstance(w, Int8Weight) else None for w in heads]
    return [None if isinstance(w, Int8Weight) else w for w in heads]


def _heads(ctx, *saved):
    return [q if q is not None else w for q, w in zip(ctx.int8_heads, saved)]


# ---------------------------------------------------------------------------
# chunked logsumexp + label-logit gather  (CE building block)
# ---------------------------------------------------------------------------

class _LseGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, ids, vocab_limit, chunk, stream):
        n = h.shape[0]
        head = _Head(h, w)
        vocab = _Vocab(w, vocab_limit, chunk, parallel_context())
        ids, own = vocab.local(ids)
        m, l = _init_stats(n, h.device, 1)
        picked = torch.zeros((n,), device=h.device)
        acc = torch.zeros(h.shape, device=h.device) if stream else None
        for c0, c1 in vocab.chunks():
            s = head.logits(c0, c1)
            m_new = torch.maximum(m, s.amax(dim=1))
            res = torch.exp(m - m_new)
            es = torch.exp(s - m_new[:, None])
            l = l * res + es.sum(dim=1)
            if stream:
                acc = acc * res[:, None] + head.fold(es, c0, c1)
            m = m_new
            picked = _pick(picked, s, ids, c0)
        (m, l, scale), = vocab.merge((m, l))
        l = vocab.sum(l)
        picked = vocab.sum(picked)
        lse = m + torch.log(l)
        ctx.stream, ctx.h_dtype = stream, h.dtype
        if stream:
            # frozen int8 head: dh = g_lse * p@W + g_picked * W[ids]
            ctx.save_for_backward(_normalized(acc, scale, l),
                                  head.rows(ids, own))
        else:
            ctx.save_for_backward(h, *_stash_heads(ctx, w), ids, lse)
            ctx.vocab = vocab
        return lse, picked

    @staticmethod
    def backward(ctx, g_lse, g_picked):
        if ctx.stream:
            ps_w, w_rows = ctx.saved_tensors
            dh = g_lse[:, None] * ps_w + g_picked[:, None] * w_rows
            return dh.to(ctx.h_dtype), None, None, None, None, None
        h, w, ids, lse = ctx.saved_tensors
        head = _Head(h, *_heads(ctx, w))
        grads = _HeadGrads(head, h, ctx.needs_input_grad[1])
        for c0, c1 in ctx.vocab.chunks():
            p = torch.exp(head.logits(c0, c1) - lse[:, None])
            ds = (g_lse[:, None] * p
                  + g_picked[:, None] * _onehot(ids, c0, c1 - c0))
            grads.add(ds, c0, c1)
        dh, dw = grads.result()
        return dh, dw, None, None, None, None


def chunked_lse_and_gather(h, w, ids, vocab_limit: int,
                           chunk: int = DEFAULT_CHUNK,
                           stream_dh: bool = False):
    """(logsumexp over the first `vocab_limit` rows of the head, logit of
    `ids`) per row, f32 [N] each, without the full logits.  h [N, D];
    w [V, D] or an Int8Weight; ids [N] (< vocab_limit).  `stream_dh`
    streams p@W in the forward for an int8 head (see the module note)."""
    stream = stream_dh and isinstance(w, Int8Weight)
    return _LseGather.apply(h, w, ids, vocab_limit, chunk, stream)


# ---------------------------------------------------------------------------
# chunked KD cross-entropy, and KD + CE fused
# ---------------------------------------------------------------------------

def _kd_stats(s_head, t_head, h_s, vocab, ce_ids=None,
              stream=False, int8_dh=False):
    """One pass over the rank's chunks of `vocab` (`_Vocab`): lse_s, lse_t,
    E_t[s], (with ce_ids, local rows) the label logits and (with `stream`)
    p_s@W_s and p_t@W_s (the rank's partial sums)."""
    n, device = h_s.shape[0], h_s.device
    m_s, l_s, m_t, l_t = _init_stats(n, device, 2)
    a = torch.zeros((n,), device=device)
    picked = torch.zeros((n,), device=device)
    acc_s = acc_t = torch.zeros(h_s.shape, device=device) if stream else None
    for c0, c1 in vocab.chunks():
        s = s_head.logits(c0, c1)
        t = t_head.logits(c0, c1)
        m_s_new = torch.maximum(m_s, s.amax(dim=1))
        res_s = torch.exp(m_s - m_s_new)
        es = torch.exp(s - m_s_new[:, None])
        l_s = l_s * res_s + es.sum(dim=1)
        m_t_new = torch.maximum(m_t, t.amax(dim=1))
        res_t = torch.exp(m_t - m_t_new)
        et = torch.exp(t - m_t_new[:, None])
        l_t = l_t * res_t + et.sum(dim=1)
        a = a * res_t + (et * s).sum(dim=1)
        if stream:
            acc_s = acc_s * res_s[:, None] + s_head.fold(es, c0, c1, int8_dh)
            acc_t = acc_t * res_t[:, None] + s_head.fold(et, c0, c1, int8_dh)
        m_s, m_t = m_s_new, m_t_new
        if ce_ids is not None:
            picked = _pick(picked, s, ce_ids, c0)
    (m_s, l_s, sc_s), (m_t, l_t, sc_t) = vocab.merge((m_s, l_s), (m_t, l_t))
    if vocab.pctx is not None:
        l_s, l_t, a, picked = vocab.sum(torch.stack([l_s, l_t, a * sc_t,
                                                     picked]))
    lse_s = m_s + torch.log(l_s)
    lse_t = m_t + torch.log(l_t)
    streamed = ((_normalized(acc_s, sc_s, l_s), _normalized(acc_t, sc_t, l_t))
                if stream else None)
    return lse_s, lse_t, a / l_t, picked, streamed


class _KdCe(torch.autograd.Function):
    """(KD, CE) sharing one pass over the student logits; ce_ids None means
    KD alone."""

    @staticmethod
    def forward(ctx, h_s, w_s, h_t, w_t, kd_weight, ce_weight, ce_ids,
                vocab_limit, chunk, int8_dh, stream):
        s_head = _Head(h_s, w_s)
        vocab = _Vocab(w_s, vocab_limit, chunk, parallel_context())
        own = None
        if ce_ids is not None:
            ce_ids, own = vocab.local(ce_ids)
        lse_s, lse_t, e_t_s, picked, streamed = _kd_stats(
            s_head, _Head(h_t, w_t), h_s, vocab, ce_ids, stream, int8_dh)
        kd = ((lse_s - e_t_s) * kd_weight).sum()
        ce = (((lse_s - picked) * ce_weight).sum() if ce_ids is not None
              else torch.zeros((), device=h_s.device))
        ctx.stream, ctx.h_dtype, ctx.int8_dh = stream, h_s.dtype, int8_dh
        if stream:
            ps_w, pt_w = streamed
            if int8_dh:   # straight-through-grade: bf16 residuals, as JAX
                ps_w, pt_w = ps_w.bfloat16(), pt_w.bfloat16()
            w_ce = s_head.rows(ce_ids, own) if ce_ids is not None else None
            ctx.save_for_backward(kd_weight, ce_weight, ps_w, pt_w, w_ce)
        else:
            ctx.save_for_backward(h_s, h_t, *_stash_heads(ctx, w_s, w_t),
                                  kd_weight, ce_weight, ce_ids, lse_s, lse_t)
            ctx.vocab = vocab
        return kd, ce

    @staticmethod
    def backward(ctx, g_kd, g_ce):
        none = (None,) * 9
        if ctx.stream:
            # the forward already holds p_s@W and p_t@W: dh is elementwise
            kd_weight, ce_weight, ps_w, pt_w, w_ce = ctx.saved_tensors
            ps_w, pt_w = ps_w.float(), pt_w.float()
            dh = (g_kd * kd_weight)[:, None] * (ps_w - pt_w)
            if w_ce is not None:
                dh = dh + (g_ce * ce_weight)[:, None] * (ps_w - w_ce)
            return (dh.to(ctx.h_dtype), None) + none
        (h_s, h_t, w_s, w_t, kd_weight, ce_weight, ce_ids, lse_s,
         lse_t) = ctx.saved_tensors
        w_s, w_t = _heads(ctx, w_s, w_t)
        s_head, t_head = _Head(h_s, w_s), _Head(h_t, w_t)
        coef_kd = (g_kd * kd_weight)[:, None]
        grads = _HeadGrads(s_head, h_s, ctx.needs_input_grad[1], ctx.int8_dh)
        for c0, c1 in ctx.vocab.chunks():
            p_s = torch.exp(s_head.logits(c0, c1) - lse_s[:, None])
            p_t = torch.exp(t_head.logits(c0, c1) - lse_t[:, None])
            ds = coef_kd * (p_s - p_t)
            if ce_ids is not None:
                ds = ds + (g_ce * ce_weight)[:, None] * (
                    p_s - _onehot(ce_ids, c0, c1 - c0))
            grads.add(ds, c0, c1)
        dh, dw = grads.result()
        return (dh, dw) + none


def chunked_kd_cross_entropy(h_s, w_s, h_t, w_t, weight, vocab_limit: int,
                             chunk: int = DEFAULT_CHUNK,
                             int8_dh: bool = False,
                             stream_dh: bool = False):
    """sum_n weight_n * -sum_v p_t(v) logp_s(v) over the first
    `vocab_limit` vocab rows.  The teacher side takes no gradient."""
    kd, _ = chunked_kd_ce(h_s, w_s, h_t, w_t, weight, None, None,
                          vocab_limit, chunk, int8_dh, stream_dh)
    return kd


def chunked_kd_ce(h_s, w_s, h_t, w_t, kd_weight, ce_weight, ce_ids,
                  vocab_limit: int, chunk: int = DEFAULT_CHUNK,
                  int8_dh: bool = False, stream_dh: bool = False):
    """(KD loss, CE loss) from one streaming pass; ce_ids < vocab_limit
    (None: KD alone, CE 0)."""
    stream = stream_dh and isinstance(w_s, Int8Weight)
    return _KdCe.apply(h_s, w_s, h_t.detach(), _detach(w_t), kd_weight,
                       ce_weight, ce_ids, vocab_limit, chunk, int8_dh, stream)


# ---------------------------------------------------------------------------
# High-level losses
# ---------------------------------------------------------------------------

class TokenLossOutput(NamedTuple):
    loss: torch.Tensor           # scalar
    num_tokens: torch.Tensor     # scalar f32


class KdCeOutput(NamedTuple):
    kd_loss: torch.Tensor
    ce_loss: torch.Tensor
    kd_tokens: torch.Tensor
    ce_tokens: torch.Tensor


def _count(mask: torch.Tensor, count_reduce) -> torch.Tensor:
    """The token count of a mask, summed by `count_reduce` (over the
    world's ranks, parallel/collectives.py `all_sum`) when given, floored
    at 1."""
    n = mask.sum()
    if count_reduce is not None:
        n = count_reduce(n)
    return n.clamp_min(1.0)


def softmax_cross_entropy(hidden, w_head, labels, ignore_index: int = -100,
                          vocab_limit: Optional[int] = None,
                          chunk: int = DEFAULT_CHUNK, shift: bool = True,
                          stream_dh: bool = False,
                          count_reduce=None) -> TokenLossOutput:
    """Causal-LM CE, token-mean over labels != ignore_index.  hidden
    [B,T,D], w_head [V,D], labels [B,T]; shift applies the next-token
    shift.  With `count_reduce` the mean divides by the world's token
    count: the loss is this rank's share of the world's mean."""
    if shift:
        hidden, labels = hidden[:, :-1], labels[:, 1:]
    b, t, d = hidden.shape
    v = _vocab_rows(w_head) if vocab_limit is None else vocab_limit
    ids = labels.reshape(b * t)
    mask = ids != ignore_index
    safe = torch.where(mask, ids, 0).long()
    lse, picked = chunked_lse_and_gather(hidden.reshape(b * t, d), w_head,
                                         safe, v, chunk, stream_dh)
    maskf = mask.float()
    denom = _count(maskf, count_reduce)
    return TokenLossOutput(((lse - picked) * maskf).sum() / denom, denom)


def _kd_inputs(hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
               vocab_limit, distill_all_tokens, count_reduce=None):
    b, t, d_s = hidden_s.shape
    v = (min(_vocab_rows(w_head_s), _vocab_rows(w_head_t))
         if vocab_limit is None else vocab_limit)
    flat = labels.reshape(b * t)
    mask = (torch.ones((b * t,), device=hidden_s.device) if distill_all_tokens
            else (flat != ignore_index).float())
    denom = _count(mask, count_reduce)
    return (hidden_s.reshape(b * t, d_s),
            hidden_t.reshape(b * t, hidden_t.shape[-1]), v, mask, denom)


def kd_align_loss(hidden_s, w_head_s, hidden_t, w_head_t, labels,
                  ignore_index: int = -100, vocab_limit: Optional[int] = None,
                  distill_all_tokens: bool = False,
                  chunk: int = DEFAULT_CHUNK, int8_dh: bool = False,
                  stream_dh: bool = False, count_reduce=None
                  ) -> TokenLossOutput:
    """Mimic-distillation loss: token-mean over the response mask of
    -sum_v p_t(v) logp_s(v), same position (no next-token shift); the
    count summed by `count_reduce` when given."""
    h_s, h_t, v, mask, denom = _kd_inputs(
        hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
        vocab_limit, distill_all_tokens, count_reduce)
    loss = chunked_kd_cross_entropy(h_s, w_head_s, h_t, w_head_t,
                                    mask / denom, v, chunk, int8_dh,
                                    stream_dh)
    return TokenLossOutput(loss, denom)


def kd_ce_align_loss(hidden_s, w_head_s, hidden_t, w_head_t, labels,
                     ignore_index: int = -100,
                     vocab_limit: Optional[int] = None,
                     distill_all_tokens: bool = False,
                     chunk: int = DEFAULT_CHUNK, int8_dh: bool = False,
                     stream_dh: bool = False, count_reduce=None
                     ) -> KdCeOutput:
    """The kd_lm objective in one streaming pass: KD same-position over the
    response mask, CE next-token-shifted (the last position's CE target is
    masked); both counts summed by `count_reduce` when given."""
    h_s, h_t, v, kd_mask, kd_denom = _kd_inputs(
        hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
        vocab_limit, distill_all_tokens, count_reduce)
    b = labels.shape[0]
    shifted = torch.cat([labels[:, 1:], torch.full(
        (b, 1), ignore_index, dtype=labels.dtype, device=labels.device)], 1)
    ce_ids = shifted.reshape(-1)
    ce_mask = ((ce_ids != ignore_index) & (ce_ids < v)).float()
    ce_denom = _count(ce_mask, count_reduce)
    safe = torch.where(ce_mask > 0, ce_ids, 0).long()
    kd, ce = chunked_kd_ce(h_s, w_head_s, h_t, w_head_t, kd_mask / kd_denom,
                           ce_mask / ce_denom, safe, v, chunk, int8_dh,
                           stream_dh)
    return KdCeOutput(kd, ce, kd_denom, ce_denom)


def sequence_log_prob(hidden, w_head, labels, ignore_index: int = -100,
                      vocab_limit: Optional[int] = None,
                      average: bool = False, chunk: int = DEFAULT_CHUNK,
                      stream_dh: bool = False) -> torch.Tensor:
    """Per-sequence sum (or mean) of response-token log-probs, [B] f32:
    labels shifted by one against the hidden states, mask = shifted labels
    != ignore_index (the reference's DPOTrainer.get_logp)."""
    hidden, labels = hidden[:, :-1], labels[:, 1:]
    b, t, d = hidden.shape
    v = _vocab_rows(w_head) if vocab_limit is None else vocab_limit
    ids = labels.reshape(b * t)
    mask = ids != ignore_index
    safe = torch.where(mask, ids, 0).long()
    lse, picked = chunked_lse_and_gather(hidden.reshape(b * t, d), w_head,
                                         safe, v, chunk, stream_dh)
    per_seq = ((picked - lse) * mask.float()).reshape(b, t).sum(dim=1)
    if average:
        per_seq = per_seq / mask.float().reshape(b, t).sum(dim=1).clamp_min(1.0)
    return per_seq


class DPOOutput(NamedTuple):
    losses: torch.Tensor          # [B] (or [2B] for kto_pair)
    chosen_rewards: torch.Tensor  # [B], no gradient
    rejected_rewards: torch.Tensor


def dpo_loss(policy_chosen_logps, policy_rejected_logps,
             reference_chosen_logps, reference_rejected_logps,
             *, beta: float = 0.1, label_smoothing: float = 0.0,
             loss_type: str = "sigmoid",
             reference_free: bool = False) -> DPOOutput:
    """Preference losses: sigmoid | hinge | ipo | kto_pair (the reference's
    dpo_trainer.py:497-562).  The rewards are beta * (policy - reference)
    log-probs, without gradient."""
    f = torch.nn.functional
    pi_logratios = policy_chosen_logps - policy_rejected_logps
    ref_logratios = 0.0 if reference_free else (
        reference_chosen_logps - reference_rejected_logps)
    logits = pi_logratios - ref_logratios

    if loss_type == "sigmoid":
        losses = (-f.logsigmoid(beta * logits) * (1 - label_smoothing)
                  - f.logsigmoid(-beta * logits) * label_smoothing)
    elif loss_type == "hinge":
        losses = torch.relu(1 - beta * logits)
    elif loss_type == "ipo":
        losses = (logits - 1 / (2 * beta)) ** 2
    elif loss_type == "kto_pair":
        chosen_kl = (policy_chosen_logps
                     - reference_chosen_logps).mean().clamp(min=0)
        rejected_kl = (policy_rejected_logps
                       - reference_rejected_logps).mean().clamp(min=0)
        chosen_logratios = policy_chosen_logps - reference_chosen_logps
        rejected_logratios = policy_rejected_logps - reference_rejected_logps
        losses = torch.cat([
            1 - torch.sigmoid(beta * (chosen_logratios - rejected_kl)),
            1 - torch.sigmoid(beta * (chosen_kl - rejected_logratios)),
        ], dim=0)
    else:
        raise ValueError(f"Unknown DPO loss type: {loss_type}")

    chosen_rewards = beta * (policy_chosen_logps
                             - reference_chosen_logps).detach()
    rejected_rewards = beta * (policy_rejected_logps
                               - reference_rejected_logps).detach()
    return DPOOutput(losses, chosen_rewards, rejected_rewards)
