"""The reference's side of each cell's comparison, from the seed and the
raw inputs: the weights are drawn again (benchmark/harness/weights.py),
the teacher quantized again, the images preprocessed and the sequences
tokenized again, here.

* `train_readings`: stage-2b distillation through the first optimizer
  update (the `accum` microbatches the program's set-up ran, in the order
  it drew them) and the microbatch after it: each microbatch's loss, the
  first microbatch's gradient per trainable leaf, the accumulated mean
  gradient per leaf as the optimizer gets it (before the clip), each
  leaf's change at the first AdamW update (global-norm clip,
  bias-corrected step 1), and the next microbatch's loss with the
  updated weights.
* `serve_gaps`: per served token of each sampled request, how far the
  token's logit lies below the reference's best at that position, from
  one forward over the prompt and the served tokens.  With `control`, the
  same gaps are read for the token that the lower precision puts first.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import weights as wmod
from benchmark.reference import image as rimage
from benchmark.reference import model as rm
from benchmark.reference import text as rtext

def trainable(name: str) -> bool:
    """The stage-2b train set: the projector, and the decoder's FFN
    matrices, experts and routers (--train_modules mlp.gate_proj
    mlp.up_proj mlp.down_proj wg)."""
    if name.startswith("projector."):
        return True
    return name.startswith("llm.layers.") and ".mlp." in name


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              floor: float = 1e-3) -> Tuple[float, str, int]:
    """Worst leaf of |prog - ref| / max(ref, the median leaf's ref) over
    the leaves whose reference norm is at least `floor` x the median's:
    (gap, leaf, leaves left out)."""
    med = statistics.median(ref.values())
    worst, where, skipped = 0.0, "", 0
    for n, r in ref.items():
        if r < floor * med:
            skipped += 1
            continue
        g = abs(prog.get(n, 0.0) - r) / max(r, med)
        if g > worst:
            worst, where = g, n
    return worst, where, skipped


def leaf_summary(prog: Dict[str, float], ref: Dict[str, float]) -> str:
    """The worst router leaf, the worst other leaf and the median leaf of
    the gaps, for the log."""
    med = statistics.median(ref.values())
    gaps = {n: abs(prog.get(n, 0.0) - r) / max(r, med) for n, r in ref.items()}
    routers = [g for n, g in gaps.items() if n.endswith(".router")]
    others = [g for n, g in gaps.items() if not n.endswith(".router")]
    return (f"worst router {max(routers, default=0):.5f}, worst other "
            f"{max(others, default=0):.5f}, median "
            f"{statistics.median(gaps.values()):.6f}")


def _teacher(cfg_t: dict, seed: int, device) -> Tuple[dict, dict]:
    """The teacher's float weights (tower-less) and its W8A8 form: the
    decoder layers' matrices that its architecture names (`INT8_LEAVES`)
    per output channel, the head per vocabulary row; each group's float
    matrices are dropped once quantized."""
    W: Dict[str, torch.Tensor] = {}
    quant = {}
    int8_leaves = rm.arch(cfg_t).INT8_LEAVES
    for g, part in wmod.iter_groups(cfg_t, seed, "teacher", device,
                                    torch.bfloat16, vision=False):
        for k, t in part.items():
            leaf = k.rsplit(".", 1)[-1]
            if g.startswith("llm.layers.") and leaf in int8_leaves:
                quant[k] = rm.quantize_weight(t, 0)
            elif k == "llm.lm_head.weight":
                quant[k] = rm.quantize_weight(t, 1)
            else:
                W[k] = t
    return W, quant


def conversation_text_ids(rec: dict, tok) -> tuple:
    """A record's text ids (the image placeholder left out): what tells
    which record a program batch holds."""
    ids, _ = rtext.conversation_ids(rec["conversations"], tok)
    return tuple(i for i in ids if i != rtext.IMAGE)


def sample_tensors(rec: dict, img: np.ndarray, tok, max_len: int, cfg: dict,
                   device):
    ids, labels = rtext.conversation_ids(rec["conversations"], tok)
    ids, labels, start = rtext.splice(ids, labels, wmod.n_image(cfg), max_len)
    px = rimage.preprocess(img, cfg["vision_config"]["image_size"], device)
    return (torch.tensor(ids, device=device), torch.tensor(labels, device=device),
            start, px)


def _forward_loss(Ws, Wt, cfg_s, cfg_t, lin_s, lin_t, batch, tok,
                  max_len, cap_tokens, aux_coef, P, device, fault=None):
    """One step's loss over the rows of `batch` [(record, image)] (one row,
    or the world's rows in the program's order), the student's graph kept
    for a backward: (loss, kd, ce, aux).  The rows are one batch: the
    token means run over all of their tokens and the sparse layers gate
    them together.  (Each tensor lives as long as it did when the
    reference took one row, so that one row computes as it did.)"""
    rows = []
    for rec, img in batch:
        ids, labels, start, px = sample_tensors(rec, img, tok, max_len, cfg_s,
                                                device)
        tower, rows_s = rm.encode_image(Ws, cfg_s, px, P)
        with torch.no_grad():
            _, rows_t = rm.encode_image(Wt, cfg_t, px, P, tower=tower)
        rows.append((ids, labels, start, rows_s, rows_t))
    segs = [r[0].shape[0] for r in rows]
    with torch.no_grad():
        h_t, _ = rm.decoder(_joined([rm.embed(i, Wt, rt, st)
                                     for i, _, st, _, rt in rows]),
                            Wt, cfg_t, lin_t, cap_tokens, train=False,
                            segments=segs)
        lt = rm.head(h_t, Wt, lin_t)
        del h_t
    h_s, aux = rm.decoder(_joined([rm.embed(i, Ws, rs, st)
                                   for i, _, st, rs, _ in rows]),
                          Ws, cfg_s, lin_s, cap_tokens, train=True,
                          remat=torch.is_grad_enabled(), segments=segs)
    labels = [r[1] for r in rows]
    if fault == "half_batch":
        labels = [lab.clone() for lab in labels]
        for lab in labels:
            lab[lab.shape[0] // 2:] = -100
    kd, ce = rm.kd_ce(rm.head(h_s, Ws, lin_s), lt, _joined(labels), segs)
    return kd + ce + aux_coef * aux, kd, ce, aux


def _joined(parts):
    """The rows one after another (one row as it is)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def train_readings(cfg_s: dict, cfg_t: dict, seed: int, samples: Sequence,
                   tok, *, max_len: int, cap_tokens: int, lr: float,
                   b1: float, b2: float, eps: float, clip: float,
                   aux_coef: float, device, after=None,
                   low: bool = False, fault: Optional[str] = None,
                   rows: int = 1, log=print) -> Dict[str, object]:
    """samples: [(record, image uint8)] of the microbatches of the first
    update, in order, `rows` to a step (a world batch of one row from each
    rank, in the program's row order); `after`: the microbatch after it
    (with `rows` > 1, its rows), whose loss is read with the updated
    weights.  `low` computes in the control's precision.
    `fault` plants a fault: "half_batch" leaves the second half of each
    sequence's tokens out of the loss and takes the mean over the rest;
    "half_accum" leaves the first half of the microbatches out of the
    accumulated mean; "flipped_update" applies the update with its sign
    flipped."""
    P = rm.Numerics(low)
    Ws = wmod.make_state(cfg_s, seed, "student", device, torch.float32)
    names = [n for n in Ws if trainable(n)]
    for n in names:
        Ws[n].requires_grad_(True)
    head_q = {"llm.lm_head.weight": rm.quantize_weight(
        Ws["llm.lm_head.weight"], 1)}
    lin_s = rm.Linear(Ws, P, head_q)
    Wt, quant_t = _teacher(cfg_t, seed, device)
    lin_t = rm.Linear(Wt, P, quant_t)
    total = {n: torch.zeros_like(Ws[n]) for n in names}
    losses, first = [], {}
    steps = [samples[i:i + rows] for i in range(0, len(samples), rows)]
    k = len(steps)
    skip = k // 2 if fault == "half_accum" else 0
    fwd = dict(max_len=max_len, cap_tokens=cap_tokens, aux_coef=aux_coef,
               P=P, device=device)
    for i, batch in enumerate(steps):
        loss, kd, ce, aux = _forward_loss(Ws, Wt, cfg_s, cfg_t, lin_s, lin_t,
                                          batch, tok, fault=fault, **fwd)
        grads = torch.autograd.grad(loss, [Ws[n] for n in names],
                                    allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None and i >= skip:
                total[n] += g
            if i == 0:
                first[n] = float(g.norm()) if g is not None else 0.0
        losses.append(float(loss.detach()))
        log(f"[reference] microbatch {i + 1}: loss {losses[-1]:.6f} "
            f"(kd {float(kd.detach()):.4f}, ce {float(ce.detach()):.4f}, "
            f"aux {float(aux.detach()):.4f})")
        del grads, loss
    out = {"losses": losses, "first_grad": first}
    with torch.no_grad():
        mean_grad = {}
        for n in names:
            total[n] /= k - skip
            mean_grad[n] = float(total[n].norm())
        norm = torch.sqrt(sum(t.float().pow(2).sum() for t in total.values()))
        scale = clip / norm if clip and norm >= clip else 1.0
        sign = -1.0 if fault == "flipped_update" else 1.0
        change = {}
        for n in names:
            m = total[n] * scale
            mu, nu = (1 - b1) * m, (1 - b2) * m * m
            upd = (mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + eps)
            change[n] = float((lr * upd).norm())
            if after is not None:
                Ws[n].sub_(sign * lr * upd)
            total[n] = None
        out.update(mean_grad=mean_grad, change=change,
                   mean_grad_norm=float(norm))
        if after is not None:
            loss, *_ = _forward_loss(Ws, Wt, cfg_s, cfg_t, lin_s, lin_t,
                                     [after] if rows == 1 else list(after),
                                     tok, fault=fault, **fwd)
            out["loss_after"] = float(loss)
            log(f"[reference] the microbatch after the update: loss "
                f"{out['loss_after']:.6f}")
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _request_logits(W, cfg, lin, P, img, question, tokens, tok, device):
    """(logits [len(tokens), V] at the served positions, the least router
    margin over the sparse layers at each of them [len(tokens)]; inf for a
    dense model)."""
    ids = rtext.tokenize(rtext.question_prompt(question), tok)
    ids, _, start = rtext.splice(ids, [0] * len(ids), wmod.n_image(cfg), 1 << 30)
    n_prompt = len(ids)
    seq = torch.tensor(ids + list(tokens[:-1]), device=device)
    px = rimage.preprocess(img, cfg["vision_config"]["image_size"], device)
    _, rows = rm.encode_image(W, cfg, px, P)
    margins: list = []
    h, _ = rm.decoder(rm.embed(seq, W, rows, start), W, cfg, lin,
                      cap_tokens=seq.shape[0], train=False, margins=margins)
    least = (torch.stack(margins).min(0).values[n_prompt - 1:] if margins
             else torch.full((len(tokens),), float("inf"), device=device))
    return rm.head(h[n_prompt - 1:], W, lin), least


@torch.no_grad()
def serve_gaps(cfg: dict, seed: int, requests: Sequence[Tuple], tok, device,
               dtype=torch.bfloat16, control: bool = False, pad_id: int = 0,
               near_tie: float = 0.0, log=print) -> Dict[str, object]:
    """requests: [(image uint8, question, served ids, ids asked for)].
    Returns the widest gap ("gap"), its request, the mean gap over the served
    tokens, the widest over the tokens whose reference routing has no near
    tie (least router margin at least `near_tie` in every sparse layer),
    the tokens compared and, per token, [gap, control gap, margin]; with
    `control` also the widest, the mean and the widest untied gap of the
    tokens the lower precision puts first."""
    W = {k: v.float() for k, v in
         wmod.make_state(cfg, seed, "model", device, dtype).items()}
    exact = rm.Numerics(False)
    lin = rm.Linear(W, exact)
    low = rm.Numerics(True)
    lin_low = rm.Linear(W, low)
    widest, where, count = 0.0, -1, 0
    per_token = []
    for r, (img, question, served, asked) in enumerate(requests):
        served = list(served)
        logits, margin = _request_logits(W, cfg, lin, exact, img, question,
                                         served or [pad_id], tok, device)
        # the server drops a served pad id from the text: put one back
        # where the reference's best is the pad id
        j = 0
        while len(served) < asked and j <= len(served):
            if j < logits.shape[0] and int(logits[j].argmax()) == pad_id and \
                    (j == len(served) or served[j] != pad_id):
                served.insert(j, pad_id)
                logits, margin = _request_logits(W, cfg, lin, exact, img,
                                                 question, served, tok, device)
            j += 1
        if not served:
            continue
        best = logits.max(-1).values
        got = logits.gather(-1, torch.tensor(served, device=device)[:, None])[:, 0]
        gaps = best - got
        if float(gaps.max()) > widest:
            widest, where = float(gaps.max()), r
        count += len(served)
        cg = [None] * len(served)
        if control:
            lo, _ = _request_logits(W, cfg, lin_low, low, img, question, served,
                                    tok, device)
            pick = lo.argmax(-1)
            cg = (best - logits.gather(-1, pick[:, None])[:, 0]).tolist()
        per_token += [[g, c, m] for g, c, m in
                      zip(gaps.tolist(), cg, margin.tolist())]

    def widest_of(col, untied=False):
        return max((t[col] for t in per_token
                    if not untied or t[2] >= near_tie), default=0.0)

    def spread(col):
        g = sorted(((t[col], t[2]) for t in per_token), reverse=True)
        return (f"top gaps (router margin) {[(round(x, 4), round(m, 4)) for x, m in g[:5]]}, "
                f"{sum(1 for x, _ in g if x > 0)} above 0")

    log(f"[reference] served: {spread(0)}"
        + (f"; control: {spread(1)}" if control else ""))
    out = {"gap": widest, "request": where, "tokens": count,
           "mean_gap": sum(t[0] for t in per_token) / max(1, len(per_token)),
           "untied_gap": widest_of(0, True),
           "near_ties": sum(1 for t in per_token if t[2] < near_tie),
           "per_token": per_token}
    if control:
        out["control_gap"] = widest_of(1)
        out["control_mean_gap"] = (sum(t[1] for t in per_token)
                                   / max(1, len(per_token)))
        out["control_untied_gap"] = widest_of(1, True)
    log(f"[reference] {len(requests)} requests, {count} served tokens "
        f"({out['near_ties']} with a router margin under {near_tie}), widest "
        f"gap {widest:.5f}, mean gap {out['mean_gap']:.6f}, widest untied "
        f"{out['untied_gap']:.5f}"
        + (f"; control widest {out['control_gap']:.5f}, mean "
           f"{out['control_mean_gap']:.6f}, widest untied "
           f"{out['control_untied_gap']:.5f}" if control else ""))
    return out
