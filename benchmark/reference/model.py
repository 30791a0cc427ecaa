"""A plain PyTorch LLaVA: CLIP ViT-L/14 tower, mlp2x_gelu projector, the
decoder of the configuration's architecture
(benchmark/reference/arch/<architecture>.py; `llava_qwen`: Qwen1.5 with
LLaVA-MoD's sparse layers), its W8A8 int8 form (per-output-channel weight
scales, dynamic per-row activation scales), and the mimic-distillation
objective (KD over the vocabulary at the same position plus next-token CE,
plus the router loss).

It reads the weights by their checkpoint names from a dict, one sequence
at a time (or the sequences of one world batch one after another, which
only the sparse layers' gating couples), with no padding, no cache and
no kernels.  Every
product goes through a `Numerics`: exact (float32, TF32 off; an int8
product as the float32 product of its integer operands) or, for the
control, one precision below the configuration's (float8 e4m3 for the
bfloat16 products, int4 for the int8 ones).  Quantized activations pass
their gradient straight through, as the program's int8 products do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

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


def arch(cfg: dict):
    """The reference's module of the configuration's decoder architecture
    (benchmark/reference/arch/<architecture>.py)."""
    from benchmark.harness import common

    return common.architecture(cfg, "reference")


def decoder(emb: torch.Tensor, W: Weights, cfg: dict, lin: Linear,
            cap_tokens: int, train: bool, remat: bool = False,
            margins: Optional[list] = None,
            segments: Optional[Sequence[int]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, D] embeddings -> (final-norm hidden [T, D], summed aux) through
    the configuration's decoder: one sequence, or the sequences of
    `segments` (their lengths) one after another, which the sparse layers
    gate together; `margins` gets each sparse layer's router margins."""
    return arch(cfg).decoder(emb, W, cfg, lin, cap_tokens, train,
                             remat=remat, margins=margins, segments=segments)


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


def kd_ce(ls: torch.Tensor, lt: torch.Tensor, labels: torch.Tensor,
          segments: Optional[Sequence[int]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(KD, CE) token means: KD = -sum_v p_t(v) log p_s(v) at the same
    position over the response tokens; CE next-token over the labels that
    follow in the same sequence (`segments`: the lengths of the sequences
    one after another; the means run over all of their tokens)."""
    logp_s = torch.log_softmax(ls, -1)
    kd_mask = (labels != -100).float()
    kd_tok = -(torch.softmax(lt, -1) * logp_s).sum(-1)
    kd = (kd_tok * kd_mask).sum() / kd_mask.sum().clamp_min(1.0)
    nxt = torch.cat([torch.cat([lab[1:], lab.new_full((1,), -100)])
                     for lab in labels.split(list(segments or [len(labels)]))])
    ce_mask = (nxt != -100).float()
    ce_tok = -logp_s.gather(-1, nxt.clamp_min(0).long()[:, None])[:, 0]
    ce = (ce_tok * ce_mask).sum() / ce_mask.sum().clamp_min(1.0)
    return kd, ce
