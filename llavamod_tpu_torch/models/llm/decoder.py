"""The decoder LLM (port of llavamod_tpu/models/llm/decoder.py: the serving
path and the training forward).

`Decoder` is an nn.Module whose state_dict keys are the JAX param-tree paths
('embed.embedding', 'layers.3.attn.wq', 'layers.2.mlp.experts.up', ...) in
the JAX layouts ([D_in, D_out] used as x @ w, stacked experts [E, D, F],
a [V, D] head), so a JAX tree loads leaf for leaf.  The forward functions
keep the JAX names and take the parameter group as `p`:

  * `attention_forward` — the fresh-prefill path (the chunk's own K/V,
    through kernel K1 on the card) and the single-token cached path
    (kernel K2 on the card), plus the plain branches the JAX package keeps
    for prefix-LM, sliding-window and ALiBi attention;
  * `mlp_forward`, `moe_block_forward` (gather dispatch, no gating groups),
    `layer_forward`, and `forward` as a Python loop over layers; with
    `remat=True` each layer is recomputed in the backward
    (`torch.utils.checkpoint`, the JAX per-layer `jax.checkpoint`).

Parameters are built trainable; which of them train is the caller's
choice (llavamod_tpu_torch/train/optim.py `apply_trainable_mask`), and
serving runs under `torch.inference_mode()`.

The KV cache is updated IN PLACE (the JAX cache is a new value each step);
`forward` returns the same tensors with the advanced `length`.

int8 W8A8: `quantize_decoder_int8` replaces float weights, in place, with
`Int8Weight`s (models/params.py) under the JAX paths ('layers.3.attn.wqkv
.w_int8', 'lm_head.weight.scale', ...).  `dense`, the expert MLP, `embed`
and `logits_from_hidden` take either form; an int8 product quantizes its
activation rows dynamically (ops/int8.py) and its backward is the JAX
straight-through estimate, so a router upstream of frozen int8 weights
still trains.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.params import Initializer, Int8Weight, ParamGroup
from llavamod_tpu_torch.ops.attention import dot_product_attention
from llavamod_tpu_torch.ops.decode_attention import flash_decode
from llavamod_tpu_torch.ops.int8 import act_quant_rows, int8_matmul
from llavamod_tpu_torch.ops.matmul import matmul_f32_out
from llavamod_tpu_torch.ops.moe import (
    GatingConfig,
    moe_ffn_gather,
    top_k_gating_compact,
)
from llavamod_tpu_torch.ops.norms import layer_norm, rms_norm
from llavamod_tpu_torch.ops.rope import apply_rope, rope_table


# ---------------------------------------------------------------------------
# Parameters and initialization
# ---------------------------------------------------------------------------

def _norm_group(cfg: DecoderConfig, ini: Initializer) -> ParamGroup:
    p = {"weight": ini.ones(cfg.hidden_size)}
    if cfg.norm == "layernorm":
        p["bias"] = ini.zeros(cfg.hidden_size)
    return ParamGroup(**p)


def _mlp_tensors(cfg: DecoderConfig, ini: Initializer, e: Optional[int] = None):
    d, f = cfg.hidden_size, cfg.intermediate_size

    def dense(din, dout):
        if e is None:
            return ini.dense(din, dout)
        return torch.stack([ini.dense(din, dout) for _ in range(e)])

    lead = () if e is None else (e,)
    p = {}
    if cfg.gated_mlp:
        p["gate"] = dense(d, f)
    p["up"] = dense(d, f)
    p["down"] = dense(f, d)
    if cfg.mlp_bias:
        p["up_bias"] = ini.zeros(*lead, f)
        p["down_bias"] = ini.zeros(*lead, d)
    return p


class MoEMLP(nn.Module):
    """{'router': [D, E], 'experts': {name: [E, ...]}} (+ residual MLP)."""

    def __init__(self, cfg: DecoderConfig, ini: Initializer):
        super().__init__()
        e = cfg.moe_num_experts
        self.router = nn.Parameter(ini.zeros(cfg.hidden_size, e))
        self.experts = ParamGroup(**_mlp_tensors(cfg, ini, e))
        if cfg.moe_use_residual:
            self.residual_mlp = ParamGroup(**_mlp_tensors(cfg, ini))
            self.coef = nn.Parameter(ini.zeros(cfg.hidden_size, 2))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, ini: Initializer, layer_idx: int):
        super().__init__()
        d = cfg.hidden_size
        h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn = {"wq": ini.dense(d, h * dh), "wk": ini.dense(d, kh * dh),
                "wv": ini.dense(d, kh * dh), "wo": ini.dense(h * dh, d)}
        if cfg.qkv_bias:
            attn.update(bq=ini.zeros(h * dh), bk=ini.zeros(kh * dh),
                        bv=ini.zeros(kh * dh))
        if cfg.o_bias:
            attn["bo"] = ini.zeros(d)
        self.input_norm = _norm_group(cfg, ini)
        self.attn = ParamGroup(**attn)
        self.is_moe = cfg.is_moe and layer_idx in cfg.moe_layers
        self.mlp = (MoEMLP(cfg, ini) if self.is_moe
                    else ParamGroup(**_mlp_tensors(cfg, ini)))
        if not cfg.parallel_block:
            self.post_attn_input_norm = _norm_group(cfg, ini)
        if cfg.post_attn_norm:
            self.post_attn_norm = _norm_group(cfg, ini)
        if cfg.post_mlp_norm:
            self.post_mlp_norm = _norm_group(cfg, ini)


class KVCache(NamedTuple):
    # [B, KH, S, D] per layer: each (batch, kv-head) history is one
    # contiguous run, which kernel K2 streams.
    k: torch.Tensor        # [L, B, KH, S_max, Dh] (bf16/f32 or int8)
    v: torch.Tensor        # [L, B, KH, S_max, Dh]
    segment: torch.Tensor  # [B, S_max] int32 (0 = empty/pad)
    length: int            # filled prefix length, shared by all rows
    # int8 mode only: per-(position, head) dequantization scales
    k_scale: Optional[torch.Tensor] = None  # [L, B, KH, S_max]
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """dtype: a torch float dtype, or 'int8' for a quantized cache with
    per-position/head symmetric scales.  The zero-filled segment row is what
    gives cached decode its causality: unwritten slots stay segment 0."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    seg = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    if dtype == "int8" or dtype == torch.int8:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       seg, 0,
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), seg, 0)


def _quantize_kv(x: torch.Tensor):
    """[..., Dh] -> (int8 values, [...] per-row scales)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


class DecoderOutput(NamedTuple):
    hidden: torch.Tensor                  # [B, T, D] final-norm output
    aux_loss: torch.Tensor                # scalar: sum of MoE aux losses
    moe_losses: Tuple[torch.Tensor, ...]  # per-MoE-layer aux values
    router_probs: Tuple[torch.Tensor, ...]  # per-MoE-layer [B*T, E] gate probs
    cache: Optional[KVCache]


def _norm(cfg: DecoderConfig, p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p.weight, getattr(p, "bias", None),
                          cfg.layernorm_eps)
    return rms_norm(x, p.weight, cfg.rms_norm_eps, offset=cfg.norm_offset)


def _activation(cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu":
        return nn.functional.silu(x)
    if cfg.activation == "gelu":
        return nn.functional.gelu(x, approximate="none")
    if cfg.activation == "gelu_tanh":
        return nn.functional.gelu(x, approximate="tanh")
    raise ValueError(cfg.activation)


# --- int8 W8A8 matmuls with a straight-through backward --------------------
# A frozen quantized weight still passes dL/dx to what trains upstream (the
# router of a quantized student body, JAX decoder.py:251-262): the backward
# is the straight-through estimate dL/dx = g @ W_deq^T, itself an int8
# product (g * scale row-quantized like a forward activation).  The int8
# weight and its scale take no gradient (they are buffers).

def _int8_rows_product(x: torch.Tensor, w_int8: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] float -> (int32 [M, N] of its row-quantized form @ w_int8
    [K, N], the rows' scales [M, 1])."""
    xq, s_x = act_quant_rows(x.reshape(-1, x.shape[-1]))
    return int8_matmul(xq, w_int8), s_x


class _DenseInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_int8, scale):
        y, s_x = _int8_rows_product(x, w_int8)
        ctx.save_for_backward(w_int8, scale)
        out = (y.float() * s_x * scale.float()).to(x.dtype)
        return out.reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        dx, s_g = _int8_rows_product(g.float() * scale.float(), w_int8.t())
        dx = (dx.float() * s_g).to(g.dtype)
        return dx.reshape(*g.shape[:-1], -1), None, None


def dense_int8(x: torch.Tensor, w_int8: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """W8A8 x @ W: x [..., in] @ {w_int8 [in, out], scale [out]}; dynamic
    per-row activation quantization, int8 product, f32 rescale."""
    return _DenseInt8.apply(x, w_int8, scale)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with w in the JAX [in, out] layout, or an `Int8Weight`
    (`dense_int8`)."""
    if isinstance(w, Int8Weight):
        return dense_int8(x, w.w_int8, w.scale)
    return x @ w


def _k_major(q: torch.Tensor) -> torch.Tensor:
    """The same [..., K, N] values stored with K contiguous.  cuBLASLt runs
    the int8 product on its fast tensor-core path only when both operands
    are K-major (`torch._int_mm` on an N-major [K, N] weight is 5-8x slower
    on the H100: PERF.md); the state_dict still shows the JAX [in, out]
    shape and values."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize(w: torch.Tensor, dim: int):
    """Symmetric int8 over `dim` (amax / 127, floored at 1e-8), f32 math."""
    wf = w.detach().float()
    scale = (wf.abs().amax(dim=dim) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(dim)), -127, 127)
    return q.to(torch.int8), scale


def quantize_dense_int8(w: torch.Tensor) -> Int8Weight:
    """[in, out] float -> Int8Weight with per-output-channel scales."""
    q, scale = _quantize(w, 0)
    return Int8Weight(_k_major(q), scale)


def quantize_head_int8(w: torch.Tensor) -> Int8Weight:
    """[V, D] head/embedding-layout weight -> Int8Weight {'w_int8' [V, D],
    'scale' [V]} with per-vocab-row scales (the layout the vocab-chunked
    losses stream; a [V, D] row-major head is K-major as h @ W^T)."""
    q, scale = _quantize(w, 1)
    return Int8Weight(q, scale)


def quantize_experts_int8(experts: nn.Module) -> nn.Module:
    """Stacked expert weights {name: [E, in, out]} -> a group of
    Int8Weights with per-(expert, output-channel) scales [E, out]."""
    out = ParamGroup()
    for name, w in experts.named_parameters(recurse=False):
        q, scale = _quantize(w, 1)
        out.add_module(name, Int8Weight(_k_major(q), scale))
    return out


def _replace(group: nn.Module, name: str, w) -> None:
    """Swap a group's float parameter `name` for `w` (the float tensor is
    dropped here, so a layer quantized in place frees its float weights)."""
    if name in group._parameters:
        del group._parameters[name]
    setattr(group, name, w)


def _float(group: nn.Module, name: str) -> bool:
    return name in group._parameters


def quantize_decoder_int8(model: "Decoder", include_lm_head: bool = False,
                          include_experts: bool = False,
                          include_embed: bool = False,
                          include_mlp: bool = True,
                          fuse: bool = True) -> "Decoder":
    """Quantize every layer's attention/MLP weights to int8 IN PLACE, one
    layer at a time (each float weight is dropped as its int8 form
    arrives), and return the module; the JAX counterpart (decoder.py:363)
    returns a new tree with the same paths.  Embedding and norms stay float.

      * include_lm_head: the output head too (per-vocab-row scales); a
        tied model gains an int8 `lm_head` copy, which `lm_head_weight`
        then prefers, and keeps its float embedding for the lookup;
      * include_embed: the embedding table (dequantized on gather);
      * include_experts: the stacked MoE experts and the residual MLP;
      * include_mlp=False: the attention projections only;
      * fuse: wq|wk|wv -> 'wqkv' and gate|up -> 'gate_up', one activation
        quantization and one wide int8 product each (forward bit-identical
        to the unfused layout).

    A weight that is already int8 is left as it is, so a second call
    changes nothing."""
    with torch.no_grad():
        if include_lm_head and not isinstance(lm_head_weight(model),
                                              Int8Weight):
            head = quantize_head_int8(lm_head_weight(model))
            if not hasattr(model, "lm_head"):
                model.lm_head = ParamGroup()
            _replace(model.lm_head, "weight", head)
        if include_embed and _float(model.embed, "embedding"):
            w_e = model.embed.embedding
            q = quantize_head_int8(w_e)
            _replace(model.embed, "embedding", Int8Weight(
                q.w_int8, q.scale, torch.zeros((0,), dtype=w_e.dtype,
                                               device=w_e.device)))
        for layer in model.layers:
            _quantize_layer(layer, include_mlp, include_experts, fuse)
    return model


def _quantize_layer(layer: "DecoderLayer", include_mlp: bool,
                    include_experts: bool, fuse: bool) -> None:
    attn = layer.attn
    if fuse and all(_float(attn, k) for k in ("wq", "wk", "wv")):
        wqkv = torch.cat([attn.wq, attn.wk, attn.wv], dim=1)
        for k in ("wq", "wk", "wv"):
            del attn._parameters[k]
        attn.wqkv = quantize_dense_int8(wqkv)
        del wqkv
    for k in ("wq", "wk", "wv", "wo"):
        if _float(attn, k):
            _replace(attn, k, quantize_dense_int8(getattr(attn, k)))
    mlp = layer.mlp
    if include_mlp and not layer.is_moe:
        if (fuse and _float(mlp, "gate") and _float(mlp, "up")
                and mlp.gate.shape == mlp.up.shape):
            gate_up = torch.cat([mlp.gate, mlp.up], dim=1)
            del mlp._parameters["gate"], mlp._parameters["up"]
            mlp.gate_up = quantize_dense_int8(gate_up)
            del gate_up
        for k in ("gate", "up", "down"):
            if _float(mlp, k):
                _replace(mlp, k, quantize_dense_int8(getattr(mlp, k)))
    if include_experts and layer.is_moe:
        if hasattr(mlp, "residual_mlp"):
            for k in ("gate", "up", "down"):
                if _float(mlp.residual_mlp, k):
                    _replace(mlp.residual_mlp, k, quantize_dense_int8(
                        getattr(mlp.residual_mlp, k)))
        if any(True for _ in mlp.experts.parameters(recurse=False)):
            mlp.experts = quantize_experts_int8(mlp.experts)


def mlp_forward(cfg: DecoderConfig, p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "gate_up"):
        # fused int8 gate|up (quantize_decoder_int8 fuse=True)
        gu = dense(x, p.gate_up)
        f = gu.shape[-1] // 2
        up = gu[..., f:]
        if cfg.mlp_bias:
            up = up + p.up_bias
        h = _activation(cfg, gu[..., :f]) * up
    else:
        up = dense(x, p.up)
        if cfg.mlp_bias:
            up = up + p.up_bias
        if cfg.gated_mlp:
            h = _activation(cfg, dense(x, p.gate)) * up
        else:
            h = _activation(cfg, up)
    out = dense(h, p.down)
    if cfg.mlp_bias:
        out = out + p.down_bias
    return out


class _ExpertDenseInt8(torch.autograd.Function):
    """Per-expert W8A8 product with the straight-through dL/dx.  There is
    no batched int8 GEMM in the library, so it loops over the experts."""

    @staticmethod
    def forward(ctx, xe, w_int8, scale):
        xq, s_x = act_quant_rows(xe)
        y = torch.stack([int8_matmul(xq[e], w_int8[e])
                         for e in range(xe.shape[0])])
        ctx.save_for_backward(w_int8, scale)
        return (y.float() * s_x * scale.float()[:, None, :]).to(xe.dtype)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        gq, s_g = act_quant_rows(g.float() * scale.float()[:, None, :])
        dx = torch.stack([int8_matmul(gq[e], w_int8[e].t())
                          for e in range(g.shape[0])])
        return (dx.float() * s_g).to(g.dtype), None, None


def expert_dense_int8(xe: torch.Tensor, w_int8: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """W8A8 per-expert matmul: xe [E, C, D] @ {w_int8 [E, D, F], scale
    [E, F]} with the straight-through dL/dx (see dense_int8)."""
    return _ExpertDenseInt8.apply(xe, w_int8, scale)


def _expert_dense(xe: torch.Tensor, w) -> torch.Tensor:
    """xe [E, C, D] @ w [E, D, F] (float, or an Int8Weight) -> [E, C, F]."""
    if isinstance(w, Int8Weight):
        return expert_dense_int8(xe, w.w_int8, w.scale)
    return torch.bmm(xe, w)


def _expert_mlp(cfg: DecoderConfig, experts: ParamGroup,
                xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] -> [E, C, D]; expert weights carry a leading E axis."""
    up = _expert_dense(xe, experts.up)
    if cfg.gated_mlp:
        h = _activation(cfg, _expert_dense(xe, experts.gate)) * up
    else:
        h = _activation(cfg, up)
    return _expert_dense(h, experts.down)


def moe_block_forward(cfg: DecoderConfig, p: MoEMLP, x: torch.Tensor,
                      train: bool, token_valid: Optional[torch.Tensor]):
    """Sparse FFN: x [B, T, D] -> (y, aux_loss, router_probs)."""
    if cfg.moe_dispatch != "gather" or cfg.moe_gating_group_size:
        raise NotImplementedError(
            "the port runs moe_dispatch='gather' without gating groups; "
            f"got {cfg.moe_dispatch!r}, group {cfg.moe_gating_group_size}")
    b, t, d = x.shape
    xs = x.reshape(b * t, d)
    gcfg = GatingConfig(
        num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        eval_capacity_factor=cfg.moe_eval_capacity_factor,
        min_capacity=cfg.moe_min_capacity)
    router_logits = xs.float() @ p.router.float()
    tv = token_valid.reshape(b * t) if token_valid is not None else None
    comp = top_k_gating_compact(router_logits, gcfg, train=train,
                                token_valid=tv)
    y = moe_ffn_gather(xs, comp, cfg.moe_num_experts,
                       gcfg.capacity(b * t, train),
                       lambda xe: _expert_mlp(cfg, p.experts, xe))
    if cfg.moe_use_residual:
        res = mlp_forward(cfg, p.residual_mlp, xs)
        coef = torch.softmax((xs @ p.coef).float(), dim=-1)
        y = y * coef[:, :1].to(y.dtype) + res * coef[:, 1:].to(res.dtype)
    return y.reshape(b, t, d), comp.aux_loss, comp.router_probs


def _alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Standard ALiBi head slopes (geometric 2^(-8i/H))."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][
            : num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def _alibi_bias(cfg: DecoderConfig, q_pos: torch.Tensor,
                kv_pos: torch.Tensor) -> torch.Tensor:
    """[B, H, T, S] additive bias: -slope * (q_pos - kv_pos)."""
    slopes = _alibi_slopes(cfg.num_heads, q_pos.device)
    dist = (q_pos[:, :, None] - kv_pos[:, None, :]).float().clamp_min(0.0)
    return -slopes[None, :, None, None] * dist[:, None]


def attention_forward(cfg: DecoderConfig, p: ParamGroup, x: torch.Tensor,
                      positions: torch.Tensor,
                      segment_ids: Optional[torch.Tensor],
                      layer_idx: int,
                      cache: Optional[KVCache],
                      attn_impl: str = "auto",
                      prefix_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D].  With a cache, k/v are written into it at
    `cache.length` (in place; the caller wrote the segment row)."""
    b, t, d = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    if hasattr(p, "wqkv"):
        # fused int8 projection (quantize_decoder_int8 fuse=True): one
        # activation quantization and one wide int8 product for q|k|v
        qkv = dense(x, p.wqkv)
        q, k, v = qkv.split([h * dh, kh * dh, kh * dh], dim=-1)
    else:
        q, k, v = dense(x, p.wq), dense(x, p.wk), dense(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, kh, dh)
    v = v.reshape(b, t, kh, dh)

    if cfg.use_rope:
        theta = cfg.rope_theta
        if cfg.use_dynamic_ntk:
            rdim = cfg.rotary_dim
            true_len = positions.max().float() + 1.0
            ctx = torch.ceil(torch.log2(true_len / cfg.rope_seq_length) + 1.0)
            alpha = torch.clamp_min(2.0 ** ctx - 1.0, 1.0)
            theta = float(cfg.rope_theta * alpha ** (rdim / (rdim - 2)))
        cos, sin = rope_table(positions, dh, theta, cfg.rotary_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cfg.use_logn_attn:
            npos = positions.float() + 1.0
            logn = torch.clamp_min(
                torch.log(npos) / math.log(float(cfg.rope_seq_length)), 1.0)
            q = (q.float() * logn[..., None, None]).to(q.dtype)

    scale = (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar
             else dh ** -0.5)
    softcap = cfg.attn_logit_softcap

    pat = cfg.sliding_window_pattern
    sliding = cfg.sliding_window if (
        cfg.sliding_window and (pat == 1 or layer_idx % pat != pat - 1)
    ) else None

    # attn_impl == "fresh" asserts the cache was EMPTY before this call (a
    # full prefill): attention runs on the chunk's own K/V, while the cache
    # is still written for the decode steps that follow.
    fresh = attn_impl == "fresh"
    chunk_attn = cache is None or (fresh and t > 1)
    out = None
    if cache is not None:
        start = cache.length
        k_bh = k.transpose(1, 2)  # [B, KH, t, D]
        v_bh = v.transpose(1, 2)
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]
        scales = None
        if cache.quantized:
            kq, ks = _quantize_kv(k_bh)
            vq, vs = _quantize_kv(v_bh)
            ck[:, :, start:start + t] = kq
            cv[:, :, start:start + t] = vq
            cks, cvs = cache.k_scale[layer_idx], cache.v_scale[layer_idx]
            cks[:, :, start:start + t] = ks
            cvs[:, :, start:start + t] = vs
            scales = (cks, cvs)
        else:
            ck[:, :, start:start + t] = k_bh.to(ck.dtype)
            cv[:, :, start:start + t] = v_bh.to(cv.dtype)
        cseg = cache.segment
        s_max = ck.shape[2]

        use_kernel = t == 1 and sliding is None and not cfg.alibi
        if chunk_attn:
            pass  # attention computed below on the fresh chunk K/V
        elif use_kernel:
            # Single-token decode: slots past `start` are still segment 0,
            # so causality needs no position mask.
            out = flash_decode(
                q[:, 0], ck, cv, kv_seg=cseg,
                k_scale=scales[0] if scales else None,
                v_scale=scales[1] if scales else None,
                scale=scale, softcap=softcap)[:, None]
        else:
            if cache.quantized:
                k_full = _dequantize_kv(ck, scales[0], q.dtype)
                v_full = _dequantize_kv(cv, scales[1], q.dtype)
            else:
                k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
            kv_pos = torch.arange(s_max, device=x.device)[None, None, None, :]
            q_pos = (start + torch.arange(t, device=x.device))[None, None, :, None]
            mask = (kv_pos <= q_pos) & (cseg[:, None, None, :] != 0)
            if sliding is not None:
                mask = mask & (kv_pos > q_pos - sliding)
            bias = None
            if cfg.alibi:
                bias = _alibi_bias(
                    cfg, (start + torch.arange(t, device=x.device))[None, :]
                    .expand(b, t),
                    torch.arange(s_max, device=x.device)[None, :].expand(b, s_max))
            out = dot_product_attention(
                q, k_full, v_full, mask=mask, bias=bias, causal=False,
                scale=scale, softcap=softcap, impl="xla", kv_layout="bksd")
    if chunk_attn:
        segs = (segment_ids, segment_ids) if segment_ids is not None else None
        bias = _alibi_bias(cfg, positions, positions) if cfg.alibi else None
        if prefix_mask is not None:
            # prefix-LM: allowed(q, k) = causal(q, k) OR prefix[k]
            q_pos = positions[:, None, :, None]
            kv_pos = positions[:, None, None, :]
            mask = (kv_pos <= q_pos) | prefix_mask[:, None, None, :]
            if segment_ids is not None:
                seg_q = segment_ids[:, None, :, None]
                seg_k = segment_ids[:, None, None, :]
                mask = mask & (seg_q == seg_k) & (seg_k != 0)
                segs = None
            if sliding is not None:
                mask = mask & (kv_pos > q_pos - sliding)
            out = dot_product_attention(q, k, v, mask=mask, bias=bias,
                                        causal=False, scale=scale,
                                        softcap=softcap, impl="xla")
        elif sliding is not None:
            q_pos = positions[:, None, :, None]
            kv_pos = q_pos.transpose(-1, -2)
            mask = kv_pos > q_pos - sliding
            out = dot_product_attention(q, k, v, mask=mask, bias=bias,
                                        causal=True, scale=scale,
                                        softcap=softcap, segment_ids=segs,
                                        impl="xla")
        else:
            # ALiBi carries a dense bias -> plain path (flash takes no bias)
            impl = "auto" if fresh else attn_impl
            out = dot_product_attention(q, k, v, bias=bias, causal=True,
                                        scale=scale, softcap=softcap,
                                        segment_ids=segs,
                                        impl="xla" if bias is not None
                                        else impl)

    out = dense(out.reshape(b, t, h * dh), p.wo)
    if cfg.o_bias:
        out = out + p.bo
    return out


def layer_forward(cfg: DecoderConfig, p: DecoderLayer, x: torch.Tensor,
                  positions, segment_ids, layer_idx: int, cache, train: bool,
                  attn_impl: str = "auto",
                  prefix_mask: Optional[torch.Tensor] = None):
    """Returns (x, aux, router_probs or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    router_probs = None
    token_valid = (segment_ids != 0) if segment_ids is not None else None

    normed = _norm(cfg, p.input_norm, x)
    attn_out = attention_forward(cfg, p.attn, normed, positions, segment_ids,
                                 layer_idx, cache, attn_impl,
                                 prefix_mask=prefix_mask)
    if cfg.post_attn_norm:
        attn_out = _norm(cfg, p.post_attn_norm, attn_out)
    rs = cfg.residual_scale

    if cfg.parallel_block:
        if p.is_moe:
            mlp_out, aux, router_probs = moe_block_forward(
                cfg, p.mlp, normed, train, token_valid)
        else:
            mlp_out = mlp_forward(cfg, p.mlp, normed)
        if rs is not None:
            attn_out = attn_out * rs
            mlp_out = mlp_out * rs
        return x + attn_out + mlp_out, aux, router_probs
    x = x + (attn_out if rs is None else attn_out * rs)
    normed2 = _norm(cfg, p.post_attn_input_norm, x)
    if p.is_moe:
        mlp_out, aux, router_probs = moe_block_forward(
            cfg, p.mlp, normed2, train, token_valid)
    else:
        mlp_out = mlp_forward(cfg, p.mlp, normed2)
    if cfg.post_mlp_norm:
        mlp_out = _norm(cfg, p.post_mlp_norm, mlp_out)
    return x + (mlp_out if rs is None else mlp_out * rs), aux, router_probs


class Decoder(nn.Module):
    """The decoder stack: {'embed', 'layers', 'final_norm', 'lm_head'?}."""

    def __init__(self, cfg: DecoderConfig, *, generator: torch.Generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        ini = Initializer(generator, device, dtype)
        self.embed = ParamGroup(
            embedding=ini.normal((cfg.vocab_size, cfg.hidden_size), 0.02))
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, ini, i) for i in range(cfg.num_layers)])
        self.final_norm = _norm_group(cfg, ini)
        if not cfg.tie_word_embeddings:
            head = {"weight": ini.normal((cfg.vocab_size, cfg.hidden_size), 0.02)}
            if cfg.lm_head_bias:
                head["bias"] = ini.zeros(cfg.vocab_size)
            self.lm_head = ParamGroup(**head)

    def forward(self, **kw) -> DecoderOutput:
        return forward(self, self.cfg, **kw)


def init(cfg: DecoderConfig, generator: torch.Generator, device=None,
         dtype=torch.float32) -> Decoder:
    return Decoder(cfg, generator=generator, device=device, dtype=dtype)


def forward(
    model: Decoder,
    cfg: DecoderConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    train: bool = False,
    attn_impl: str = "auto",
    remat: bool = False,
    prefix_mask: Optional[torch.Tensor] = None,
) -> DecoderOutput:
    """Run the decoder stack.  Provide input_ids OR inputs_embeds.

    positions: [B, T] absolute positions (defaults to arange, or
    cache.length offset during decode).  segment_ids: [B, T] (0 = padding).
    remat: recompute each layer in the backward, keeping only the layer
    boundaries (no-cache path only, as in the JAX package).
    """
    if inputs_embeds is None:
        inputs_embeds = embed(model, cfg, input_ids)
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        base = torch.arange(t, device=dev)[None, :]
        if cache is not None:
            base = base + cache.length
        positions = base.expand(b, t)
    if cache is not None:
        start = cache.length
        if start + t > cache.segment.shape[1]:
            raise ValueError(f"cache of {cache.segment.shape[1]} slots cannot "
                             f"take {t} more after {start}")
        seg_new = (segment_ids.to(torch.int32) if segment_ids is not None
                   else torch.ones((b, t), dtype=torch.int32, device=dev))
        cache.segment[:, start:start + t] = seg_new

    x = inputs_embeds
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    moe_losses: List[torch.Tensor] = []
    router_probs: List[torch.Tensor] = []
    rematted = remat and cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        args = (cfg, layer, x, positions, segment_ids, i, cache, train,
                attn_impl, prefix_mask)
        if rematted:
            x, aux, probs = checkpoint(layer_forward, *args,
                                       use_reentrant=False)
        else:
            x, aux, probs = layer_forward(*args)
        aux_total = aux_total + aux
        if probs is not None:
            moe_losses.append(aux)
            router_probs.append(probs)
    x = _norm(cfg, model.final_norm, x)
    new_cache = cache._replace(length=cache.length + t) if cache is not None else None
    return DecoderOutput(x, aux_total, tuple(moe_losses), tuple(router_probs),
                         new_cache)


def embed(model: Decoder, cfg: DecoderConfig,
          input_ids: torch.Tensor) -> torch.Tensor:
    w = model.embed.embedding
    ids = input_ids.long()
    if isinstance(w, Int8Weight):
        # int8 table (per-row scales): gather the int8 rows and their
        # scales, dequantize to the dtype `dtype_ref` carries
        tgt = w.dtype_ref.dtype if hasattr(w, "dtype_ref") else torch.bfloat16
        e = (w.w_int8[ids].float() * w.scale[ids][..., None]).to(tgt)
    else:
        e = w[ids]
    if cfg.embed_scale is not None:
        e = (e.float() * cfg.embed_scale).to(e.dtype)
    return e


def lm_head_weight(model: Decoder, cfg: Optional[DecoderConfig] = None):
    """[V, D] output-projection weight (tied embedding or separate head),
    or its Int8Weight.  An explicit `lm_head` wins even for tied models
    (that is where the int8 copy of a tied head lives)."""
    if hasattr(model, "lm_head"):
        return model.lm_head.weight
    return model.embed.embedding


def logits_from_hidden(model: Decoder, cfg: DecoderConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> f32 logits [B, T, V]: the head matmul accumulates in
    f32 and keeps the f32 result, as the JAX einsum with
    preferred_element_type=f32."""
    w = lm_head_weight(model, cfg)
    if cfg.logit_scale is not None:
        hidden = hidden * cfg.logit_scale
    b, t, d = hidden.shape
    h = hidden.reshape(b * t, d)
    if isinstance(w, Int8Weight):
        # int8 head: dynamic per-row activation quantization, int8 product
        hq, s_h = act_quant_rows(h)
        logits = int8_matmul(hq, w.w_int8.t()).float() * s_h * w.scale[None, :]
    else:
        logits = matmul_f32_out(h, w)
    logits = logits.reshape(b, t, -1)
    if hasattr(model, "lm_head") and hasattr(model.lm_head, "bias"):
        logits = logits + model.lm_head.bias.float()
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
