"""A plain PyTorch LLaVA: CLIP ViT-L/14 tower, mlp2x_gelu projector and a
Qwen1.5 decoder (RMSNorm, rotary embeddings in the rotate-half layout, q/k/v
biases, SwiGLU) with LLaVA-MoD's sparse layers (top-k routing with
DeepSpeed's capacity rules and load-balancing loss), its W8A8 int8 form
(per-output-channel weight scales, dynamic per-row activation scales), and
the mimic-distillation objective (KD over the vocabulary at the same
position plus next-token CE, plus the router loss).

It reads the weights by their checkpoint names from a dict, one sequence
at a time, with no padding, no cache, no batching and no kernels.  Every
product goes through a `Numerics`: exact (float32, TF32 off; an int8
product as the float32 product of its integer operands) or, for the
control, one precision below the configuration's (float8 e4m3 for the
bfloat16 products, int4 for the int8 ones).  Quantized activations pass
their gradient straight through, as the program's int8 products do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def int_rows(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last axis) quantization: (integer values as
    float, scales [..., 1]); scale = max(amax / qmax, 1e-8), round half to
    even, clip to +-qmax."""
    qmax = 2 ** (bits - 1) - 1
    s = (x.detach().abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-8)
    return torch.clamp(torch.round(x.detach() / s), -qmax, qmax), s


def quantize_weight(w: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim` of a float weight: (int8, f32 scales)."""
    wf = w.detach().float()
    s = (wf.abs().amax(dim=dim) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(wf / s.unsqueeze(dim)), -127, 127)
    return q.to(torch.int8), s


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = (x.detach().abs().amax(dim=dim, keepdim=True) / 448.0).clamp_min(1e-12)
    return _ste(x, (x.detach() / s).to(torch.float8_e4m3fn).float() * s)


class Numerics:
    """How the reference computes its products: `low` False is the
    reference, True the control."""

    def __init__(self, low: bool = False):
        self.low = low

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product the configuration computes in bfloat16: a [..., K] @
        b [K, N] (b may be batched like a)."""
        a, b = a.float(), b.float()
        if self.low:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    def qmm(self, x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
            ) -> torch.Tensor:
        """A W8A8 product: x [..., K] @ (int8 wq [K, N] with scales [N])."""
        x = x.float()
        if self.low:
            w = wq.float() * ws.float()
            wq4 = torch.clamp(torch.round(w / (w.abs().amax(0) / 7.0)
                                          .clamp_min(1e-8)), -7, 7)
            ws = (w.abs().amax(0) / 7.0).clamp_min(1e-8)
            xq, sx = int_rows(x, 4)
            return _ste(x, xq * sx) @ (wq4 * ws) if x.requires_grad else \
                (xq @ wq4) * sx * ws
        xq, sx = int_rows(x, 8)
        if x.requires_grad:
            return _ste(x, xq * sx) @ (wq.float() * ws.float())
        return (xq @ wq.float()) * sx * ws.float()


# ---------------------------------------------------------------------------
# The vision tower and the projector
# ---------------------------------------------------------------------------

def _layer_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def _linear(x, W: Weights, pre: str, P: Numerics):
    return P.mm(x, W[pre + ".kernel"]) + W[pre + ".bias"].float()


def vision_tower(W: Weights, v: dict, pixels: torch.Tensor, select_layer: int,
                 P: Numerics) -> torch.Tensor:
    """pixels [N, 3, S, S] -> patch features [N, patches, D] of the
    selected layer (CLS dropped)."""
    n, c, s, _ = pixels.shape
    p = v["patch_size"]
    g = s // p
    x = pixels.float().reshape(n, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(n, g * g, c * p * p)
    x = P.mm(x, W["vision.patch_embed.kernel"]) + W["vision.patch_embed.bias"].float()
    cls = W["vision.class_token"].float().expand(n, 1, -1)
    x = torch.cat([cls, x], 1) + W["vision.pos_embed"].float()
    eps = v["layer_norm_eps"]
    x = _layer_norm(x, W["vision.pre_ln.weight"], W["vision.pre_ln.bias"], eps)
    heads = v["num_attention_heads"]
    dh = v["hidden_size"] // heads
    blocks = v["num_hidden_layers"] + select_layer + 1
    for i in range(blocks):
        pre = f"vision.layers.{i}"
        h = _layer_norm(x, W[pre + ".ln1.weight"], W[pre + ".ln1.bias"], eps)
        q, k, vv = (_linear(h, W, f"{pre}.attn.{m}", P)
                    .reshape(n, -1, heads, dh).transpose(1, 2) for m in "qkv")
        a = torch.softmax(P.mm(q, k.transpose(-1, -2)) * dh ** -0.5, -1)
        a = P.mm(a, vv).transpose(1, 2).reshape(n, -1, heads * dh)
        x = x + _linear(a, W, pre + ".attn.o", P)
        h = _layer_norm(x, W[pre + ".ln2.weight"], W[pre + ".ln2.bias"], eps)
        h = _linear(h, W, pre + ".mlp.fc1", P)
        h = h * torch.sigmoid(1.702 * h)
        x = x + _linear(h, W, pre + ".mlp.fc2", P)
    return x[:, 1:]


def projector(W: Weights, feats: torch.Tensor, P: Numerics) -> torch.Tensor:
    h = _linear(feats, W, "projector.layers.0", P)
    return _linear(F.gelu(h), W, "projector.layers.1", P)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, T, Dh], positions 0..T-1, HF rotate-half layout."""
    t, dh = x.shape[1], x.shape[2]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    f = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([f, f], -1)
    rot = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1)
    return x * emb.cos() + rot * emb.sin()


class Linear:
    """A decoder product by weight name: float, or int8 (teacher) when the
    name is in `quant` ({name: (int8 [K, N], scales [N])})."""

    def __init__(self, W: Weights, P: Numerics,
                 quant: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
        self.W, self.P, self.quant = W, P, quant or {}

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if name in self.quant:
            return self.P.qmm(x, *self.quant[name])
        return self.P.mm(x, self.W[name])


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


def decoder_layer(x: torch.Tensor, W: Weights, cfg: dict, i: int,
                  lin: Linear, cap_tokens: int, train: bool,
                  margins: Optional[list] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] of one sequence (positions 0..T-1, causal) -> (x, aux)."""
    pre = f"llm.layers.{i}"
    eps = cfg["rms_norm_eps"]
    h_, kh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or cfg["hidden_size"] // h_
    t = x.shape[0]
    h = rms_norm(x, W[pre + ".input_norm.weight"], eps)
    q = lin(h, pre + ".attn.wq") + W[pre + ".attn.bq"].float()
    k = lin(h, pre + ".attn.wk") + W[pre + ".attn.bk"].float()
    v = lin(h, pre + ".attn.wv") + W[pre + ".attn.bv"].float()
    q = rope(q.reshape(t, h_, dh).transpose(0, 1), cfg["rope_theta"])
    k = rope(k.reshape(t, kh, dh).transpose(0, 1), cfg["rope_theta"])
    v = v.reshape(t, kh, dh).transpose(0, 1)
    if kh != h_:
        k = k.repeat_interleave(h_ // kh, 0)
        v = v.repeat_interleave(h_ // kh, 0)
    s = lin.P.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    a = lin.P.mm(a, v).transpose(0, 1).reshape(t, h_ * dh)
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
            margins: Optional[list] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, D] embeddings -> (final-norm hidden [T, D], summed aux);
    `margins` gets each sparse layer's router margins (moe_block)."""
    x, aux = emb.float(), torch.zeros((), device=emb.device)
    for i in range(cfg["num_hidden_layers"]):
        fn = (lambda x_, i_=i: decoder_layer(x_, W, cfg, i_, lin, cap_tokens,
                                              train, margins))
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        aux = aux + a
    return rms_norm(x, W["llm.final_norm.weight"], cfg["rms_norm_eps"]), aux


def embed(ids: torch.Tensor, W: Weights, image_rows: torch.Tensor,
          start: int) -> torch.Tensor:
    """Token embeddings [T, D] with the image's feature rows at `start`."""
    e = W["llm.embed.embedding"][ids.long()].float()
    if start >= 0:
        n = image_rows.shape[0]
        e = torch.cat([e[:start], image_rows.float(), e[start + n:]], 0)
    return e


def head(h: torch.Tensor, W: Weights, lin: Linear) -> torch.Tensor:
    """f32 logits [T, V] (the head [V, D] as h @ W^T)."""
    name = "llm.lm_head.weight"
    if name in lin.quant:
        q, s = lin.quant[name]
        return lin.P.qmm(h, q.t(), s)
    return lin.P.mm(h, W[name].t())


def encode_image(W: Weights, cfg: dict, pixels: torch.Tensor, P: Numerics,
                 tower: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tower features, projected rows [patches, D]) of one image."""
    if tower is None:
        with torch.no_grad():
            tower = vision_tower(W, cfg["vision_config"], pixels[None],
                                 cfg["mm_vision_select_layer"], P)[0]
    return tower, projector(W, tower, P)


def kd_ce(ls: torch.Tensor, lt: torch.Tensor, labels: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(KD, CE) token means: KD = -sum_v p_t(v) log p_s(v) at the same
    position over the response tokens; CE next-token over the labels that
    follow."""
    logp_s = torch.log_softmax(ls, -1)
    kd_mask = (labels != -100).float()
    kd_tok = -(torch.softmax(lt, -1) * logp_s).sum(-1)
    kd = (kd_tok * kd_mask).sum() / kd_mask.sum().clamp_min(1.0)
    nxt = torch.cat([labels[1:], labels.new_full((1,), -100)])
    ce_mask = (nxt != -100).float()
    ce_tok = -logp_s.gather(-1, nxt.clamp_min(0).long()[:, None])[:, 0]
    ce = (ce_tok * ce_mask).sum() / ce_mask.sum().clamp_min(1.0)
    return kd, ce
