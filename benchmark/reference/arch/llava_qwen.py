"""The `llava_qwen` architecture on the reference's side: a plain float32
Qwen1.5 decoder (RMSNorm, rotary embeddings in the rotate-half layout,
q/k/v biases, SwiGLU) with LLaVA-MoD's sparse layers (top-k routing with
DeepSpeed's capacity rules and load-balancing loss), reading the weights
by their checkpoint names (benchmark/harness/arch/llava_qwen.py `groups`)
through a `Linear`, one product at a time.

`decoder` takes the embeddings of one sequence, or of several one after
another (`segments`: their lengths), as the program's world batch holds
them: each sequence attends only to itself, from position 0, and the
sparse layers gate the tokens of all of them together, in that order.
`INT8_LEAVES` names the matrices that a W8A8 teacher holds in int8.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.model import Linear, Numerics, Weights, rms_norm

INT8_LEAVES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, T, Dh], positions 0..T-1, HF rotate-half layout."""
    t, dh = x.shape[1], x.shape[2]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    f = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([f, f], -1)
    rot = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


def moe_gating(logits: torch.Tensor, k: int, capacity: int
               ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """DeepSpeed top-k gating of [S, E] router logits: ([(expert [S],
    combine weight [S])] per choice, aux loss).  argmax takes the first of
    tied values; choice c's tokens queue behind every earlier choice's in
    each expert; a token past the capacity is dropped; the kept gates are
    renormalised; aux = mean_e(mean gate * top-1 share) * E^2."""
    s, e = logits.shape
    gates = torch.softmax(logits.float(), -1)
    remaining = gates.detach().clone()
    choices, masks = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, -1)
        m = F.one_hot(idx, e).float()
        choices.append(idx)
        masks.append(m)
        remaining = remaining.masked_fill(m > 0, float("-inf"))
    me = gates.mean(0)
    ce = masks[0].mean(0)
    aux = (me * ce).mean() * e * e
    prior = torch.zeros(e, device=logits.device)
    kept_gate = []
    for c in range(k):
        loc = torch.cumsum(masks[c], 0) - masks[c] + prior
        kept = ((loc < capacity).float() * masks[c]).sum(-1)
        kept_gate.append((gates * masks[c]).sum(-1) * kept)
        prior = prior + masks[c].sum(0)
    denom = sum(kept_gate).clamp_min(torch.finfo(torch.float32).eps) \
        if k > 1 else torch.ones_like(kept_gate[0])
    return [(choices[c], kept_gate[c] / denom) for c in range(k)], aux


def capacity(tokens: int, factor: float, k: int, e: int, min_cap: int) -> int:
    return max(int(-(-tokens * factor * k // e)), min_cap)


def _swiglu(x, lin: Linear, pre: str):
    return lin(F.silu(lin(x, pre + ".gate")) * lin(x, pre + ".up"), pre + ".down")


def moe_block(x: torch.Tensor, W: Weights, cfg: dict, pre: str, P: Numerics,
              cap_tokens: int, train: bool, margins: Optional[list] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`margins`, when given, gets each token's router margin [T]: its k-th
    largest router logit less its (k+1)-th, how near its expert choice is
    to a tie."""
    moe = cfg["moe"]
    e, k = moe["num_experts"], moe["num_experts_per_tok"]
    factor = moe["capacity_factor"] if train else moe["eval_capacity_factor"]
    cap = capacity(cap_tokens, factor, k, e, moe["min_capacity"])
    logits = x.float() @ W[pre + ".router"].float()
    if margins is not None and k < e:
        top = logits.detach().topk(k + 1, -1).values
        margins.append(top[:, k - 1] - top[:, k])
    routes, aux = moe_gating(logits, k, cap)
    out = torch.zeros_like(x)
    for j in range(e):
        for idx, wgt in routes:
            rows = (idx == j).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            xe = x[rows]
            h = F.silu(P.mm(xe, W[pre + ".experts.gate"][j])) * \
                P.mm(xe, W[pre + ".experts.up"][j])
            y = P.mm(h, W[pre + ".experts.down"][j])
            out = out.index_add(0, rows, y * wgt[rows, None])
    return out, aux


def _biased(y: torch.Tensor, W: Weights, name: str) -> torch.Tensor:
    """y plus the bias `name`, where the configuration has one
    (`qkv_bias`)."""
    return y + W[name].float() if name in W else y


def _attention(q, k, v, cfg: dict, lin: Linear) -> torch.Tensor:
    """Causal attention of one sequence from its projections q [T, H*dh],
    k, v [T, KH*dh] (positions 0..T-1) -> [T, H*dh]."""
    h_, kh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or cfg["hidden_size"] // h_
    t = q.shape[0]
    q = rope(q.reshape(t, h_, dh).transpose(0, 1), cfg["rope_theta"])
    k = rope(k.reshape(t, kh, dh).transpose(0, 1), cfg["rope_theta"])
    v = v.reshape(t, kh, dh).transpose(0, 1)
    if kh != h_:
        k = k.repeat_interleave(h_ // kh, 0)
        v = v.repeat_interleave(h_ // kh, 0)
    s = lin.P.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    return lin.P.mm(a, v).transpose(0, 1).reshape(t, h_ * dh)


def decoder_layer(x: torch.Tensor, W: Weights, cfg: dict, i: int,
                  lin: Linear, cap_tokens: int, train: bool,
                  margins: Optional[list] = None,
                  segments: Optional[Sequence[int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] of one sequence (positions 0..T-1, causal), or of the
    sequences of `segments` one after another -> (x, aux)."""
    pre = f"llm.layers.{i}"
    eps = cfg["rms_norm_eps"]
    segments = list(segments) if segments else [x.shape[0]]
    h = rms_norm(x, W[pre + ".input_norm.weight"], eps)
    q, k, v = (_biased(lin(h, f"{pre}.attn.w{n}"), W, f"{pre}.attn.b{n}")
               for n in "qkv")
    if len(segments) == 1:      # one sequence: no split in the graph
        a = _attention(q, k, v, cfg, lin)
    else:
        a = torch.cat([_attention(q_, k_, v_, cfg, lin) for q_, k_, v_ in
                       zip(q.split(segments), k.split(segments),
                           v.split(segments))])
    x = x + lin(a, pre + ".attn.wo")
    h = rms_norm(x, W[pre + ".post_attn_input_norm.weight"], eps)
    if pre + ".mlp.router" in W:
        y, aux = moe_block(h, W, cfg, pre + ".mlp", lin.P, cap_tokens, train,
                           margins)
    else:
        y, aux = _swiglu(h, lin, pre + ".mlp"), torch.zeros((), device=x.device)
    return x + y, aux


def decoder(emb: torch.Tensor, W: Weights, cfg: dict, lin: Linear,
            cap_tokens: int, train: bool, remat: bool = False,
            margins: Optional[list] = None,
            segments: Optional[Sequence[int]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, D] embeddings -> (final-norm hidden [T, D], summed aux);
    `margins` gets each sparse layer's router margins (moe_block)."""
    x, aux = emb.float(), torch.zeros((), device=emb.device)
    for i in range(cfg["num_hidden_layers"]):
        fn = (lambda x_, i_=i: decoder_layer(x_, W, cfg, i_, lin, cap_tokens,
                                              train, margins, segments))
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        aux = aux + a
    return rms_norm(x, W["llm.final_norm.weight"], cfg["rms_norm_eps"]), aux
