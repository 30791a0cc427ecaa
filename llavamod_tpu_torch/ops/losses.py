"""Training losses over vocab chunks (port of llavamod_tpu/ops/losses.py,
exact dh path).

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

For CE and the sequence log-probs, `stream_dh=True` is accepted: in the JAX
package it reorders the backward of a frozen head exactly (dh from p@W
streamed in the forward), so the two-pass backward here gives the same dh;
whether dW is formed is decided by the head the Function is handed
(`ctx.needs_input_grad`), never by the flag.  The int8 heads and the KD
`stream_dh` / `int8_dh` variants (a straight-through estimate in the JAX
package) are not ported yet (ROADMAP Queue 1, item 3) and raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llavamod_tpu_torch.ops.matmul import matmul_f32_out

DEFAULT_CHUNK = 8192


def _exact_only(int8_dh: bool, stream_dh: bool, *heads) -> None:
    if int8_dh or stream_dh or any(isinstance(w, dict) for w in heads):
        raise NotImplementedError(
            "the int8 heads and the stream_dh / int8_dh loss modes are not "
            "ported yet (ROADMAP Queue 1, item 3: int8 W8A8); the port "
            "runs the exact dh path")


def _chunks(vocab_limit: int, chunk: int):
    for c0 in range(0, vocab_limit, chunk):
        yield c0, min(c0 + chunk, vocab_limit)


def _online(m, l, s):
    """One step of the running (max, sum of exp) over a chunk's columns."""
    m_new = torch.maximum(m, s.amax(dim=1))
    l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(dim=1)
    return m_new, l


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


class _HeadGrads:
    """Accumulates dL/dh over the chunks and writes dL/dW chunk by chunk
    (only when the head takes a gradient)."""

    def __init__(self, h, w, want_dw: bool):
        self.h, self.w = h, w
        self.dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        self.dw = torch.zeros_like(w) if want_dw else None

    def add(self, ds, c0, c1):
        w_c = self.w[c0:c1]
        self.dh += matmul_f32_out(ds.to(w_c.dtype), w_c.t())
        if self.dw is not None:
            self.dw[c0:c1] = matmul_f32_out(ds.to(self.h.dtype).t(),
                                            self.h.t()).to(self.w.dtype)

    def result(self):
        return self.dh.to(self.h.dtype), self.dw


# ---------------------------------------------------------------------------
# chunked logsumexp + label-logit gather  (CE building block)
# ---------------------------------------------------------------------------

class _LseGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, ids, vocab_limit, chunk):
        n = h.shape[0]
        m, l = _init_stats(n, h.device, 1)
        picked = torch.zeros((n,), device=h.device)
        for c0, c1 in _chunks(vocab_limit, chunk):
            s = matmul_f32_out(h, w[c0:c1])
            m, l = _online(m, l, s)
            picked = _pick(picked, s, ids, c0)
        lse = m + torch.log(l)
        ctx.save_for_backward(h, w, ids, lse)
        ctx.vocab = (vocab_limit, chunk)
        return lse, picked

    @staticmethod
    def backward(ctx, g_lse, g_picked):
        h, w, ids, lse = ctx.saved_tensors
        grads = _HeadGrads(h, w, ctx.needs_input_grad[1])
        for c0, c1 in _chunks(*ctx.vocab):
            s = matmul_f32_out(h, w[c0:c1])
            p = torch.exp(s - lse[:, None])
            ds = (g_lse[:, None] * p
                  + g_picked[:, None] * _onehot(ids, c0, c1 - c0))
            grads.add(ds, c0, c1)
        dh, dw = grads.result()
        return dh, dw, None, None, None


def chunked_lse_and_gather(h, w, ids, vocab_limit: int,
                           chunk: int = DEFAULT_CHUNK,
                           stream_dh: bool = False):
    """(logsumexp over the first `vocab_limit` rows of the head, logit of
    `ids`) per row, f32 [N] each, without the full logits.  h [N, D];
    w [V, D]; ids [N] (< vocab_limit).  `stream_dh` (a frozen head in the
    JAX package) gives the same gradients as the exact two-pass backward,
    which runs either way (see the module note)."""
    _exact_only(False, False, w)
    return _LseGather.apply(h, w, ids, vocab_limit, chunk)


# ---------------------------------------------------------------------------
# chunked KD cross-entropy, and KD + CE fused
# ---------------------------------------------------------------------------

def _kd_stats(h_s, w_s, h_t, w_t, vocab_limit, chunk, ce_ids=None):
    """One pass: lse_s, lse_t, E_t[s] and (with ce_ids) the label logits."""
    n = h_s.shape[0]
    m_s, l_s, m_t, l_t = _init_stats(n, h_s.device, 2)
    a = torch.zeros((n,), device=h_s.device)
    picked = torch.zeros((n,), device=h_s.device)
    for c0, c1 in _chunks(vocab_limit, chunk):
        s = matmul_f32_out(h_s, w_s[c0:c1])
        t = matmul_f32_out(h_t, w_t[c0:c1])
        m_s, l_s = _online(m_s, l_s, s)
        m_t_new = torch.maximum(m_t, t.amax(dim=1))
        rescale = torch.exp(m_t - m_t_new)
        et = torch.exp(t - m_t_new[:, None])
        l_t = l_t * rescale + et.sum(dim=1)
        a = a * rescale + (et * s).sum(dim=1)
        m_t = m_t_new
        if ce_ids is not None:
            picked = _pick(picked, s, ce_ids, c0)
    lse_s = m_s + torch.log(l_s)
    lse_t = m_t + torch.log(l_t)
    return lse_s, lse_t, a / l_t, picked


class _KdCe(torch.autograd.Function):
    """(KD, CE) sharing one pass over the student logits; ce_ids None means
    KD alone."""

    @staticmethod
    def forward(ctx, h_s, w_s, h_t, w_t, kd_weight, ce_weight, ce_ids,
                vocab_limit, chunk):
        lse_s, lse_t, e_t_s, picked = _kd_stats(h_s, w_s, h_t, w_t,
                                                vocab_limit, chunk, ce_ids)
        kd = ((lse_s - e_t_s) * kd_weight).sum()
        ce = (((lse_s - picked) * ce_weight).sum() if ce_ids is not None
              else torch.zeros((), device=h_s.device))
        ctx.save_for_backward(h_s, w_s, h_t, w_t, kd_weight, ce_weight,
                              ce_ids, lse_s, lse_t)
        ctx.vocab = (vocab_limit, chunk)
        return kd, ce

    @staticmethod
    def backward(ctx, g_kd, g_ce):
        (h_s, w_s, h_t, w_t, kd_weight, ce_weight, ce_ids, lse_s,
         lse_t) = ctx.saved_tensors
        coef_kd = (g_kd * kd_weight)[:, None]
        grads = _HeadGrads(h_s, w_s, ctx.needs_input_grad[1])
        for c0, c1 in _chunks(*ctx.vocab):
            p_s = torch.exp(matmul_f32_out(h_s, w_s[c0:c1]) - lse_s[:, None])
            p_t = torch.exp(matmul_f32_out(h_t, w_t[c0:c1]) - lse_t[:, None])
            ds = coef_kd * (p_s - p_t)
            if ce_ids is not None:
                ds = ds + (g_ce * ce_weight)[:, None] * (
                    p_s - _onehot(ce_ids, c0, c1 - c0))
            grads.add(ds, c0, c1)
        dh, dw = grads.result()
        return dh, dw, None, None, None, None, None, None, None


def chunked_kd_cross_entropy(h_s, w_s, h_t, w_t, weight, vocab_limit: int,
                             chunk: int = DEFAULT_CHUNK,
                             int8_dh: bool = False,
                             stream_dh: bool = False):
    """sum_n weight_n * -sum_v p_t(v) logp_s(v) over the first
    `vocab_limit` vocab rows.  The teacher side takes no gradient."""
    _exact_only(int8_dh, stream_dh, w_s, w_t)
    kd, _ = _KdCe.apply(h_s, w_s, h_t.detach(), w_t.detach(), weight, None,
                        None, vocab_limit, chunk)
    return kd


def chunked_kd_ce(h_s, w_s, h_t, w_t, kd_weight, ce_weight, ce_ids,
                  vocab_limit: int, chunk: int = DEFAULT_CHUNK,
                  int8_dh: bool = False, stream_dh: bool = False):
    """(KD loss, CE loss) from one streaming pass; ce_ids < vocab_limit."""
    _exact_only(int8_dh, stream_dh, w_s, w_t)
    return _KdCe.apply(h_s, w_s, h_t.detach(), w_t.detach(), kd_weight,
                       ce_weight, ce_ids, vocab_limit, chunk)


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


def softmax_cross_entropy(hidden, w_head, labels, ignore_index: int = -100,
                          vocab_limit: Optional[int] = None,
                          chunk: int = DEFAULT_CHUNK, shift: bool = True,
                          stream_dh: bool = False) -> TokenLossOutput:
    """Causal-LM CE, token-mean over labels != ignore_index.  hidden
    [B,T,D], w_head [V,D], labels [B,T]; shift applies the next-token
    shift."""
    if shift:
        hidden, labels = hidden[:, :-1], labels[:, 1:]
    b, t, d = hidden.shape
    v = w_head.shape[0] if vocab_limit is None else vocab_limit
    ids = labels.reshape(b * t)
    mask = ids != ignore_index
    safe = torch.where(mask, ids, 0).long()
    lse, picked = chunked_lse_and_gather(hidden.reshape(b * t, d), w_head,
                                         safe, v, chunk, stream_dh)
    maskf = mask.float()
    denom = maskf.sum().clamp_min(1.0)
    return TokenLossOutput(((lse - picked) * maskf).sum() / denom, denom)


def _kd_inputs(hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
               vocab_limit, distill_all_tokens):
    b, t, d_s = hidden_s.shape
    v = (min(w_head_s.shape[0], w_head_t.shape[0]) if vocab_limit is None
         else vocab_limit)
    flat = labels.reshape(b * t)
    mask = (torch.ones((b * t,), device=hidden_s.device) if distill_all_tokens
            else (flat != ignore_index).float())
    denom = mask.sum().clamp_min(1.0)
    return (hidden_s.reshape(b * t, d_s),
            hidden_t.reshape(b * t, hidden_t.shape[-1]), v, mask, denom)


def kd_align_loss(hidden_s, w_head_s, hidden_t, w_head_t, labels,
                  ignore_index: int = -100, vocab_limit: Optional[int] = None,
                  distill_all_tokens: bool = False,
                  chunk: int = DEFAULT_CHUNK, int8_dh: bool = False,
                  stream_dh: bool = False) -> TokenLossOutput:
    """Mimic-distillation loss: token-mean over the response mask of
    -sum_v p_t(v) logp_s(v), same position (no next-token shift)."""
    h_s, h_t, v, mask, denom = _kd_inputs(
        hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
        vocab_limit, distill_all_tokens)
    loss = chunked_kd_cross_entropy(h_s, w_head_s, h_t, w_head_t,
                                    mask / denom, v, chunk, int8_dh,
                                    stream_dh)
    return TokenLossOutput(loss, denom)


def kd_ce_align_loss(hidden_s, w_head_s, hidden_t, w_head_t, labels,
                     ignore_index: int = -100,
                     vocab_limit: Optional[int] = None,
                     distill_all_tokens: bool = False,
                     chunk: int = DEFAULT_CHUNK, int8_dh: bool = False,
                     stream_dh: bool = False) -> KdCeOutput:
    """The kd_lm objective in one streaming pass: KD same-position over the
    response mask, CE next-token-shifted (the last position's CE target is
    masked)."""
    h_s, h_t, v, kd_mask, kd_denom = _kd_inputs(
        hidden_s, w_head_s, hidden_t, w_head_t, labels, ignore_index,
        vocab_limit, distill_all_tokens)
    b = labels.shape[0]
    shifted = torch.cat([labels[:, 1:], torch.full(
        (b, 1), ignore_index, dtype=labels.dtype, device=labels.device)], 1)
    ce_ids = shifted.reshape(-1)
    ce_mask = ((ce_ids != ignore_index) & (ce_ids < v)).float()
    ce_denom = ce_mask.sum().clamp_min(1.0)
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
    v = w_head.shape[0] if vocab_limit is None else vocab_limit
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
