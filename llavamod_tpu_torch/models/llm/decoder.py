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
  * `mlp_forward`, `moe_block_forward`, `layer_forward`, and `forward` as
    a Python loop over layers.  The MoE block gates all tokens at once or,
    with `moe_gating_group_size`, fixed-size token groups independently
    (padded to a group multiple with invalid tokens), and dispatches by
    `moe_dispatch`: 'gather', 'ragged' (only the kept rows, one product per
    expert over its contiguous row block) or 'einsum' (one-hot
    contractions);
  * recomputation in the backward (`torch.utils.checkpoint`, the JAX
    `jax.checkpoint`): `remat=True` recomputes each layer, keeping only
    the layer boundaries, or with `remat_policy='dots'` keeping the matmul
    outputs too; `remat_policy='moe'` recomputes only the sparse-FFN block.

Parameters are built trainable; which of them train is the caller's
choice (llavamod_tpu_torch/train/optim.py `apply_trainable_mask`), and
serving runs under `torch.inference_mode()`.

The KV cache is updated IN PLACE (the JAX cache is a new value each step);
`forward` returns the same tensors with the advanced `length`.  A cache
that carries `slot` (a device tensor) takes a single-token step's K/V,
scales and segment entry at that slot (`index_copy_`), not at `length`, so
that one captured CUDA graph of the step serves every position
(generation.py); `length` then only bounds the write on the host.

Tensor parallelism (parallel/sharding.py holds each rank's slices): under
a parallel context whose tensor group has more than one rank, each rank
runs H / tensor query and KH / tensor KV heads through the same kernels,
the column-parallel products (wq / wk / wv or wqkv, gate / up or gate_up,
the experts' up and gate) on the replicated input and the row-parallel
ones (wo, down, the experts' down) reduced over the group; the MoE gate
runs on the full hidden, the same on every tensor rank, and the expert
outputs are reduced after the combine.  With `seq_shard_activations`
(sequence parallelism) the residual stream between the blocks is the
rank's T-shard [B, T / tensor, D]: the norms run on it, the shards are
gathered before each column-parallel product and the row-parallel output
is reduce-scattered over T.  The embedding is vocab-parallel, and
`forward` hands the final hidden, whole, to the vocab-parallel head of the
losses (ops/losses.py).  A row-parallel W8A8 product quantizes each row
with the whole row's scale (a max over the group) and sums the ranks'
int32 products before the f32 rescale, so it gives the single-process
bits.  The KV-cache (generation) path runs under a tensor split too: the
cache holds the rank's KH / tensor KV heads (`init_cache`), kernel K2 runs
on them and `wo` is row-parallel; with a cache the residual stream is never
T-sharded (a decode step has T = 1), as the JAX package applies its
sequence constraint only without one.

Pipeline parallelism (parallel/pipeline.py): under a parallel context
whose pipe group has more than one rank the decoder holds only its stage's
layers, and the no-cache layer loop with `scan_layers` is the GPipe
microbatch pipeline (`pipeline.pipeline_layers`).  The calls that the JAX
package runs un-pipelined (a KV cache, or `scan_layers` off) run the
stages in turn on the whole batch (`pipeline.sequential_layers`): a
stage's cache holds its own layers (`init_cache`; slot `layer_idx -
cache.first_layer`), and the router probes of every stage come back in
layer order on every stage.

int8 W8A8: `quantize_decoder_int8` replaces float weights, in place, with
`Int8Weight`s (models/params.py) under the JAX paths ('layers.3.attn.wqkv
.w_int8', 'lm_head.weight.scale', ...).  `dense`, the expert MLP, `embed`
and `logits_from_hidden` take either form; an int8 product quantizes its
activation rows dynamically (ops/int8.py) and its backward is the JAX
straight-through estimate, so a router upstream of frozen int8 weights
still trains.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.params import Initializer, Int8Weight, ParamGroup
from llavamod_tpu_torch.parallel import pipeline
from llavamod_tpu_torch.parallel.collectives import (
    column_in,
    copy_in,
    current as parallel_context,
    gather_copies,
    reduce_out,
    row_out,
    split_seq,
    tensor_gather,
    tensor_max,
    tensor_reduce_scatter,
    tensor_size,
    tensor_sum,
)
from llavamod_tpu_torch.ops.attention import dot_product_attention
from llavamod_tpu_torch.ops.decode_attention import flash_decode
from llavamod_tpu_torch.ops.int8 import act_quant_rows, int8_matmul
from llavamod_tpu_torch.ops.matmul import matmul_f32_out
from llavamod_tpu_torch.ops.moe import (
    CompactGating,
    GatingConfig,
    moe_ffn,
    moe_ffn_gather,
    moe_ffn_gather_grouped,
    moe_ffn_ragged,
    moe_ffn_ragged_grouped,
    top_k_gating,
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

    def forward(self, cfg: DecoderConfig, x: torch.Tensor, positions,
                segment_ids, layer_idx: int, cache, train: bool,
                attn_impl: str = "auto",
                prefix_mask: Optional[torch.Tensor] = None):
        """`layer_forward` through the module call, so that a sharded layer
        gathers its parameters (FSDP2's hooks fire on the call only)."""
        return layer_forward(cfg, self, x, positions, segment_ids, layer_idx,
                             cache, train, attn_impl, prefix_mask)


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
    # the global index of the layer in slot 0: a pipeline stage's first
    # layer (its cache holds its own L layers), else 0
    first_layer: int = 0
    # a single-token step's write position as a device tensor [1] (int64),
    # read on the device rather than from `length` (a replayed CUDA graph);
    # None: `length`
    slot: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """dtype: a torch float dtype, or 'int8' for a quantized cache with
    per-position/head symmetric scales.  The zero-filled segment row is what
    gives cached decode its causality: unwritten slots stay segment 0.
    Under a tensor split the cache holds the rank's KH / tensor KV heads;
    under pipe > 1 the layers of the rank's stage."""
    pctx = parallel_context()
    kh = cfg.num_kv_heads // tensor_size(pctx)
    layers = range(cfg.num_layers)
    if pipeline.pipe_size() > 1:
        layers = pipeline.stage_block(cfg, pctx.pipe_size, pctx.pipe_rank)
    shape = (len(layers), batch, kh, max_len, cfg.head_dim)
    seg = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    if dtype == "int8" or dtype == torch.int8:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       seg, 0,
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       layers.start)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), seg, 0,
                   first_layer=layers.start)


def _write_at(cache: KVCache, t: int):
    """Where a call of `t` tokens writes: `cache.slot` for one token when
    the cache carries it, else the int `cache.length`."""
    return cache.slot if t == 1 and cache.slot is not None else cache.length


def _write(dst: torch.Tensor, dim: int, at, src: torch.Tensor) -> None:
    """dst[at:at + t] = src along `dim`: a slice for an int `at`, an
    `index_copy_` for a device tensor."""
    if isinstance(at, torch.Tensor):
        dst.index_copy_(dim, at, src.to(dst.dtype))
    else:
        dst.narrow(dim, at, src.shape[dim]).copy_(src)


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

def _row_max(pctx):
    """The row-scale reduction of an int8 product whose rows are split over
    the tensor group (a max over it), or None."""
    if tensor_size(pctx) == 1:
        return None
    return lambda amax: tensor_max(amax, pctx)


def _int8_rows_product(x: torch.Tensor, w_int8: torch.Tensor, row_max=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] float -> (int32 [M, N] of its row-quantized form @ w_int8
    [K, N], the rows' scales [M, 1]); `row_max` reduces the rows' absmax
    when x holds a slice of each row's K."""
    xq, s_x = act_quant_rows(x.reshape(-1, x.shape[-1]), row_max)
    return int8_matmul(xq, w_int8), s_x


class _DenseInt8(torch.autograd.Function):
    """Column-parallel (or unsplit) W8A8 product: a rank's output columns
    are exact; the straight-through backward quantizes each cotangent row
    with the whole row's scale (`pctx`)."""

    @staticmethod
    def forward(ctx, x, w_int8, scale, pctx):
        y, s_x = _int8_rows_product(x, w_int8)
        ctx.save_for_backward(w_int8, scale)
        ctx.pctx = pctx
        out = (y.float() * s_x * scale.float()).to(x.dtype)
        return out.reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        dx, s_g = _int8_rows_product(g.float() * scale.float(), w_int8.t(),
                                     _row_max(ctx.pctx))
        dx = (dx.float() * s_g).to(g.dtype)
        return dx.reshape(*g.shape[:-1], -1), None, None, None


class _RowDenseInt8(torch.autograd.Function):
    """Row-parallel W8A8 product, x [B, T, K / tensor] @ w_int8 [K / tensor,
    N]: each row is quantized with the whole row's scale (a max over the
    tensor group) and the ranks' int32 products are summed (all-reduced,
    or with `seq` reduce-scattered over T) before the f32 rescale: the
    single-process bits.  The straight-through backward is column-parallel:
    the whole cotangent rows (gathered over T with `seq`) times the rank's
    rows of W."""

    @staticmethod
    def forward(ctx, x, w_int8, scale, pctx, seq):
        b, t = x.shape[:2]
        y, s_x = _int8_rows_product(x, w_int8, _row_max(pctx))
        n = y.shape[-1]
        if seq:
            y = tensor_reduce_scatter(y.reshape(b, t, n), pctx, 1)
            s_x = s_x.reshape(b, t, 1).chunk(pctx.tensor_size, 1)[
                pctx.tensor_rank]
        else:
            y, s_x = tensor_sum(y, pctx).reshape(b, t, n), s_x.reshape(b, t, 1)
        ctx.save_for_backward(w_int8, scale)
        ctx.pctx, ctx.seq = pctx, seq
        return (y.float() * s_x * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        if ctx.seq:
            g = tensor_gather(g, ctx.pctx, 1)
        dx, s_g = _int8_rows_product(g.float() * scale.float(), w_int8.t())
        dx = (dx.float() * s_g).to(g.dtype)
        return dx.reshape(*g.shape[:-1], -1), None, None, None, None


def dense_int8(x: torch.Tensor, w_int8: torch.Tensor,
               scale: torch.Tensor, pctx=None) -> torch.Tensor:
    """W8A8 x @ W: x [..., in] @ {w_int8 [in, out], scale [out]}; dynamic
    per-row activation quantization, int8 product, f32 rescale.  `pctx`:
    the parallel context of a column-parallel product (its backward)."""
    return _DenseInt8.apply(x, w_int8, scale, pctx)


def dense(x: torch.Tensor, w, pctx=None) -> torch.Tensor:
    """x @ w with w in the JAX [in, out] layout, or an `Int8Weight`
    (`dense_int8`); a column-parallel product under a tensor split takes
    the parallel context `pctx`."""
    if isinstance(w, Int8Weight):
        return dense_int8(x, w.w_int8, w.scale,
                          pctx if tensor_size(pctx) > 1 else None)
    return x @ w


def row_dense(x: torch.Tensor, w, pctx, seq: bool) -> torch.Tensor:
    """A row-parallel product x [B, T, K / tensor] @ w [K / tensor, N],
    reduced over the tensor group (`row_out`); the int8 form sums int32
    partial products (`_RowDenseInt8`).  Without a tensor split, `dense`."""
    if tensor_size(pctx) == 1:
        return dense(x, w)
    if isinstance(w, Int8Weight):
        return _RowDenseInt8.apply(x, w.w_int8, w.scale, pctx, seq)
    return row_out(x @ w, pctx, seq)


def _tp(cfg: DecoderConfig):
    """(parallel context, tensor degree, sequence parallel) of a forward."""
    pctx = parallel_context()
    tp = tensor_size(pctx)
    return pctx, tp, bool(cfg.seq_shard_activations) and tp > 1


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
    """x [B, T, D] (the rank's T-shard under sequence parallelism) ->
    [B, T, D]: column-parallel gate / up, row-parallel down under a
    tensor split."""
    pctx, tp, seq = _tp(cfg)
    if tp > 1:
        x = column_in(x, pctx, seq)
    if hasattr(p, "gate_up"):
        # fused int8 gate|up (quantize_decoder_int8 fuse=True); a rank's
        # slice is its gate columns, then its up columns
        gu = dense(x, p.gate_up, pctx)
        f = gu.shape[-1] // 2
        up = gu[..., f:]
        if cfg.mlp_bias:
            up = up + p.up_bias
        h = _activation(cfg, gu[..., :f]) * up
    else:
        up = dense(x, p.up, pctx)
        if cfg.mlp_bias:
            up = up + p.up_bias
        if cfg.gated_mlp:
            h = _activation(cfg, dense(x, p.gate, pctx)) * up
        else:
            h = _activation(cfg, up)
    out = row_dense(h, p.down, pctx, seq)
    if cfg.mlp_bias:
        out = out + p.down_bias
    return out


class _ExpertDenseInt8(torch.autograd.Function):
    """Per-expert W8A8 product with the straight-through dL/dx.  There is
    no batched int8 GEMM in the library, so it loops over the experts.
    `fwd_max` / `bwd_max` reduce the row absmax of the forward's rows (a
    row-parallel product) / of the backward's cotangent rows (a
    column-parallel one) over the tensor group."""

    @staticmethod
    def forward(ctx, xe, w_int8, scale, fwd_max, bwd_max):
        xq, s_x = act_quant_rows(xe, fwd_max)
        y = torch.stack([int8_matmul(xq[e], w_int8[e])
                         for e in range(xe.shape[0])])
        ctx.save_for_backward(w_int8, scale)
        ctx.bwd_max = bwd_max
        return (y.float() * s_x * scale.float()[:, None, :]).to(xe.dtype)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        gq, s_g = act_quant_rows(g.float() * scale.float()[:, None, :],
                                 ctx.bwd_max)
        dx = torch.stack([int8_matmul(gq[e], w_int8[e].t())
                          for e in range(g.shape[0])])
        return (dx.float() * s_g).to(g.dtype), None, None, None, None


def expert_dense_int8(xe: torch.Tensor, w_int8: torch.Tensor,
                      scale: torch.Tensor, fwd_max=None,
                      bwd_max=None) -> torch.Tensor:
    """W8A8 per-expert matmul: xe [E, C, D] @ {w_int8 [E, D, F], scale
    [E, F]} with the straight-through dL/dx (see dense_int8)."""
    return _ExpertDenseInt8.apply(xe, w_int8, scale, fwd_max, bwd_max)


def _expert_dense(xe: torch.Tensor, w, row: bool = False) -> torch.Tensor:
    """xe [E, C, D] @ w [E, D, F] (float, or an Int8Weight) -> [E, C, F];
    `row`: the product is row-parallel under a tensor split (its output is
    the rank's partial sum)."""
    if isinstance(w, Int8Weight):
        rmax = _row_max(parallel_context())
        return expert_dense_int8(xe, w.w_int8, w.scale,
                                 rmax if row else None,
                                 None if row else rmax)
    return torch.bmm(xe, w)


def _expert_mlp(cfg: DecoderConfig, experts: ParamGroup,
                xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] -> [E, C, D]; expert weights carry a leading E axis
    (under a tensor split, the rank's F slice: the output is its partial
    sum)."""
    up = _expert_dense(xe, experts.up)
    if cfg.gated_mlp:
        h = _activation(cfg, _expert_dense(xe, experts.gate)) * up
    else:
        h = _activation(cfg, up)
    return _expert_dense(h, experts.down, row=True)


def _group_sizes(group_sizes) -> List[int]:
    """Per-expert row counts on the host (one read of a device tensor)."""
    if isinstance(group_sizes, torch.Tensor):
        return group_sizes.tolist()
    return [int(n) for n in group_sizes]


def _ragged_products(x: torch.Tensor, w: torch.Tensor, sizes: List[int],
                     transpose: bool = False) -> torch.Tensor:
    """Rows of x grouped by expert (contiguous blocks of `sizes`) times
    that expert's w [E, K, N] (or its transpose): one product per
    non-empty block; rows past the blocks give zeros.  An int8 pair gives
    the exact int32 product (`int8_matmul`)."""
    int8 = x.dtype == torch.int8
    parts, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            we = w[e].t() if transpose else w[e]
            xe = x[start:start + n]
            parts.append(int8_matmul(xe, we) if int8 else xe @ we)
        start += n
    n_out = w.shape[1] if transpose else w.shape[2]
    tail = x.shape[0] - start
    if tail or not parts:
        parts.append(torch.zeros((tail, n_out), device=x.device,
                                 dtype=torch.int32 if int8 else x.dtype))
    return torch.cat(parts)


def _row_expert_map(sizes: List[int], e: int, m: int, device) -> torch.Tensor:
    """Row index -> expert id of the expert-major ragged layout (rows past
    the blocks map to the last expert, as the JAX searchsorted clamp)."""
    ids = torch.repeat_interleave(torch.arange(e, device=device),
                                  torch.tensor(sizes, device=device))
    return torch.cat([ids, torch.full((m - ids.shape[0],), e - 1,
                                      device=device, dtype=ids.dtype)])


class _RaggedDenseInt8(torch.autograd.Function):
    """W8A8 ragged per-expert product with the straight-through dL/dx: per-
    row activation scales, the weight scales gathered by the row -> expert
    map, one int8 product per expert block (JAX `ragged_dense_int8`)."""

    @staticmethod
    def forward(ctx, xr, w_int8, scale, sizes, fwd_max, bwd_max):
        row_expert = _row_expert_map(sizes, w_int8.shape[0], xr.shape[0],
                                     xr.device)
        xq, s_x = act_quant_rows(xr, fwd_max)
        y = _ragged_products(xq, w_int8, sizes)
        s_w = scale.float()[row_expert]
        ctx.save_for_backward(w_int8, scale, row_expert)
        ctx.sizes, ctx.bwd_max = sizes, bwd_max
        return (y.float() * s_x * s_w).to(xr.dtype)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale, row_expert = ctx.saved_tensors
        gq, s_g = act_quant_rows(g.float() * scale.float()[row_expert],
                                 ctx.bwd_max)
        dx = _ragged_products(gq, w_int8, ctx.sizes, transpose=True)
        return (dx.float() * s_g).to(g.dtype), None, None, None, None, None


def ragged_dense_int8(xr: torch.Tensor, w_int8: torch.Tensor,
                      scale: torch.Tensor, group_sizes, fwd_max=None,
                      bwd_max=None) -> torch.Tensor:
    """W8A8 ragged per-expert matmul: xr [M, D] (rows grouped by expert,
    `group_sizes` [E]) @ {w_int8 [E, D, F], scale [E, F]}, straight-through
    dL/dx (`fwd_max` / `bwd_max` as `expert_dense_int8`)."""
    return _RaggedDenseInt8.apply(xr, w_int8, scale,
                                  _group_sizes(group_sizes), fwd_max, bwd_max)


def _ragged_dense(xr: torch.Tensor, w, group_sizes,
                  row: bool = False) -> torch.Tensor:
    """Ragged per-expert matmul: xr [M, D] (rows grouped by expert,
    group_sizes [E]) @ w [E, D, F] (float, or an Int8Weight) -> [M, F].
    Only the sum(group_sizes) kept rows are computed.  The JAX package
    uses `lax.ragged_dot`; here each expert's contiguous row block is one
    matmul, so the counts are read on the host.  `row` as
    `_expert_dense`."""
    sizes = _group_sizes(group_sizes)
    if isinstance(w, Int8Weight):
        rmax = _row_max(parallel_context())
        return ragged_dense_int8(xr, w.w_int8, w.scale, sizes,
                                 rmax if row else None,
                                 None if row else rmax)
    return _ragged_products(xr, w, sizes)


def _expert_mlp_ragged(cfg: DecoderConfig, experts: ParamGroup,
                       xr: torch.Tensor, group_sizes) -> torch.Tensor:
    """Ragged-layout expert FFN: xr [M, D] -> [M, D] (ops/moe.py
    `moe_ffn_ragged`); the counts are read on the host once for the
    three products."""
    sizes = _group_sizes(group_sizes)
    up = _ragged_dense(xr, experts.up, sizes)
    if cfg.gated_mlp:
        h = _activation(cfg, _ragged_dense(xr, experts.gate, sizes)) * up
    else:
        h = _activation(cfg, up)
    return _ragged_dense(h, experts.down, sizes, row=True)


def _grouped_moe(cfg: DecoderConfig, gcfg: GatingConfig, xs: torch.Tensor,
                 router_logits: torch.Tensor,
                 tv: Optional[torch.Tensor], train: bool, expert_fn,
                 group: int):
    """Einsum dispatch over fixed-size token groups gated independently
    (DeepSpeed's per-rank gating).  Returns (y, aux, probs)."""
    s, d = xs.shape
    e = cfg.moe_num_experts
    g = s // group
    xg = xs.reshape(g, group, d)
    tvg = tv.reshape(g, group) if tv is not None else None
    gate = top_k_gating(router_logits.reshape(g, group, e), gcfg,
                        train=train, token_valid=tvg)
    c = gate.dispatch.shape[-1]
    xe = torch.einsum("gsec,gsd->gecd", gate.dispatch.to(xs.dtype), xg)
    xe = xe.permute(1, 0, 2, 3).reshape(e, g * c, d)
    ye = expert_fn(xe)
    ye = ye.reshape(e, g, c, d).permute(1, 0, 2, 3)
    y = torch.einsum("gsec,gecd->gsd", gate.combine.to(ye.dtype), ye)
    return y.reshape(s, d), gate.aux_loss.mean(), gate.router_probs.reshape(s, e)


_DISPATCH = ("gather", "ragged", "einsum")


def _expert_fns(cfg: DecoderConfig, p: MoEMLP):
    """(capacity-layout, ragged) expert FFNs of block `p`, each through the
    experts group's module call."""
    def dense(xe):
        return p.experts(functools.partial(_expert_mlp, cfg), xe)

    def ragged(xr, sizes):
        return p.experts(functools.partial(_expert_mlp_ragged, cfg), xr,
                         sizes)
    return dense, ragged


def _moe_distributed(cfg: DecoderConfig, gcfg: GatingConfig, p: MoEMLP,
                     xs: torch.Tensor, router_logits: torch.Tensor,
                     tv: Optional[torch.Tensor], train: bool, pctx):
    """The sparse FFN of this rank's tokens xs [n, D] as the single-process
    block computes them within the rows group's tokens (every rank of it
    owns distinct rows; under a tensor split the output is the rank's
    partial sum over its F slice of the experts).  Grouped gating whose
    groups tile each rank's rows (segment by segment) stays local, the aux
    loss the mean over the rows group's gating groups.  Otherwise the
    router logits are gathered (the router's gradient flows back through
    the gather) and the rows group's tokens are gated as the single process
    gates them: as one set, or in groups padded at the end of those
    tokens; the rank keeps its own rows' choices.  Each kept
    choice then goes to the rank that owns its expert
    (`_expert_parallel_ffn`).  Returns (y, aux, router_probs)."""
    n = xs.shape[0]
    e = cfg.moe_num_experts
    group = cfg.moe_gating_group_size
    if group and n * pctx.rows > group and not (n // pctx.segments) % group:
        g = n // group
        comp = top_k_gating_compact(
            router_logits.reshape(g, group, e), gcfg, train=train,
            token_valid=tv.reshape(g, group) if tv is not None else None)
        k = comp.expert.shape[-1]
        expert, kept, weight = (t.reshape(n, k) for t in (
            comp.expert, comp.kept, comp.weight))
        aux = pctx.gather_values(comp.aux_loss.reshape(-1)).mean()
        probs = comp.router_probs.reshape(n, e)
    else:
        full, idx = pctx.gather_rows(router_logits)
        tv_full = (None if tv is None
                   else pctx.gather_rows(tv.to(torch.uint8))[0].bool())
        s = full.shape[0]
        if group and s > group:
            pad = -s % group
            if pad:
                full = nn.functional.pad(full, (0, 0, 0, pad))
                tv_full = nn.functional.pad(
                    tv_full if tv_full is not None
                    else torch.ones((s,), dtype=torch.bool,
                                    device=xs.device), (0, pad))
            g = full.shape[0] // group
            comp = top_k_gating_compact(
                full.reshape(g, group, e), gcfg, train=train,
                token_valid=(tv_full.reshape(g, group) if tv_full is not None
                             else None))
            aux = comp.aux_loss.mean()
        else:
            comp = top_k_gating_compact(full, gcfg, train=train,
                                        token_valid=tv_full)
            aux = comp.aux_loss
        k = comp.expert.shape[-1]
        expert, kept, weight = (t.reshape(-1, k)[idx] for t in (
            comp.expert, comp.kept, comp.weight))
        probs = comp.router_probs.reshape(-1, e)[idx]
    y = _expert_parallel_ffn(cfg, p, xs, expert, kept, weight, pctx)
    return y, aux, probs


def _expert_parallel_ffn(cfg: DecoderConfig, p: MoEMLP, xs: torch.Tensor,
                         expert, kept, weight, pctx):
    """Send this rank's kept choices [n, k] to the ranks that own their
    experts (E / expert each, in rank order) over the expert group, run
    the local experts there on the rows received, send the outputs back
    and combine them with the gate weights, as `moe_ffn_gather` combines
    (under a tensor split the outputs are partial sums, so the weights'
    gradient is all-reduced over the group, `copy_in`).
    The rows go expert-major, so the counts per (rank, local expert) that
    travel first say every row's expert; they are the one host read of
    the block.  The exchange runs whenever a context is up, a group of one
    included."""
    n, d = xs.shape
    k = expert.shape[1]
    e = cfg.moe_num_experts
    e_local = e // pctx.expert_size
    flat_e = expert.reshape(-1).long()
    flat_kept = kept.reshape(-1)
    # the kept choices expert-major, the dropped ones after them
    order = torch.argsort(torch.where(flat_kept, flat_e, e), stable=True)
    counts = torch.zeros((e,), dtype=torch.long, device=xs.device)
    counts.scatter_add_(0, flat_e, flat_kept.long())
    recv_counts, (sent, got) = pctx.exchange_counts(
        counts.reshape(pctx.expert_size, e_local))
    send, recv = [sum(c) for c in sent], [sum(c) for c in got]
    pairs = order[:sum(send)]
    x_recv = pctx.exchange(xs[pairs // k], send, recv)
    cap = max(sum(col) for col in zip(*got))
    y_recv = _local_experts(cfg, p, x_recv, recv_counts, cap)
    y_send = pctx.exchange_back(y_recv, send, recv)
    picked = xs.new_zeros((n * k, d)).index_copy(0, pairs, y_send)
    weight = copy_in(weight, pctx)
    y = (picked.reshape(n, k, d).float() * weight.float()[..., None]).sum(1)
    return y.to(xs.dtype)


def _local_experts(cfg: DecoderConfig, p: MoEMLP, x: torch.Tensor,
                   counts: torch.Tensor, cap: int) -> torch.Tensor:
    """The rank's experts on the rows it received, x [r, D]: from each
    source rank in turn, `counts[source, j]` rows for local expert j, at
    most `cap` rows for one expert.  The rows are laid out as
    `moe_dispatch` asks, each expert's rows compacted to slots
    0..count-1: a batch [E_local, cap, D] (gather), the one-hot
    contractions over it (einsum), or the rows expert-major (ragged).  So
    the rows computed follow what the rank received, not the world's
    capacity.  Returns [r, D], row for row."""
    r = x.shape[0]
    n_src, e_local = counts.shape
    cap = max(1, cap)
    dev = x.device
    e_loc = torch.repeat_interleave(
        torch.arange(e_local, device=dev).repeat(n_src), counts.reshape(-1),
        output_size=r)
    totals = counts.sum(0)
    offsets = torch.cumsum(totals, 0) - totals
    order = torch.argsort(e_loc, stable=True)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(r, device=dev) - offsets[e_loc[order]]
    expert_fn, expert_fn_ragged = _expert_fns(cfg, p)
    comp = CompactGating(e_loc[:, None], slot[:, None],
                         torch.ones((r, 1), device=dev),
                         torch.ones((r, 1), dtype=torch.bool, device=dev),
                         None, None, None)
    if cfg.moe_dispatch == "ragged":
        return moe_ffn_ragged(x, comp, e_local, cap, expert_fn_ragged)
    if cfg.moe_dispatch == "einsum":
        onehot = torch.zeros((r, e_local, cap), device=dev)
        onehot[torch.arange(r, device=dev), e_loc, slot] = 1.0
        return moe_ffn(x, onehot, onehot, expert_fn)
    return moe_ffn_gather(x, comp, e_local, cap, expert_fn)


def moe_block_forward(cfg: DecoderConfig, p: MoEMLP, x: torch.Tensor,
                      train: bool, token_valid: Optional[torch.Tensor]):
    """Sparse FFN: x [B, T, D] -> (y, aux_loss, router_probs).

    With `moe_gating_group_size` = G and B*T > G, every G consecutive
    tokens are gated on their own (capacity from G, aux loss the mean over
    groups); B*T off a multiple of G is padded with invalid tokens, which
    the gate never routes, rather than falling back to global gating.
    Under a parallel context (parallel/collectives.py) the block computes
    the single-process block over the rows group's tokens
    (`_moe_distributed`); under a tensor split every tensor rank gates the
    same tokens alike (with sequence parallelism the router logits of the
    T-shards are gathered), runs its F slice of the experts on the whole
    hidden and the partial outputs are reduced after the combine.  The
    experts run through the `experts` group's module call."""
    if cfg.moe_dispatch not in _DISPATCH:
        raise ValueError(f"moe_dispatch must be one of {_DISPATCH}; got "
                         f"{cfg.moe_dispatch!r}")
    pctx, tp, seq = _tp(cfg)
    x_in = x
    e = cfg.moe_num_experts
    router_logits = x.reshape(-1, x.shape[-1]).float() @ p.router.float()
    if seq:
        router_logits = gather_copies(
            router_logits.reshape(x.shape[0], x.shape[1], e), pctx
        ).reshape(-1, e)
    if tp > 1:
        x = column_in(x, pctx, seq)
    b, t, d = x.shape
    n = b * t
    xs = x.reshape(n, d)
    gcfg = GatingConfig(
        num_experts=e, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        eval_capacity_factor=cfg.moe_eval_capacity_factor,
        min_capacity=cfg.moe_min_capacity)
    tv = token_valid.reshape(n) if token_valid is not None else None
    expert_fn, expert_fn_ragged = _expert_fns(cfg, p)
    ragged = cfg.moe_dispatch == "ragged"
    group = cfg.moe_gating_group_size
    if pctx is not None:
        y, aux, probs = _moe_distributed(cfg, gcfg, p, xs, router_logits, tv,
                                         train, pctx)
    elif group and n > group:
        pad = -n % group
        if pad:
            xs = nn.functional.pad(xs, (0, 0, 0, pad))
            router_logits = nn.functional.pad(router_logits, (0, 0, 0, pad))
            tv = nn.functional.pad(
                tv if tv is not None
                else torch.ones((n,), dtype=torch.bool, device=x.device),
                (0, pad))
        s = xs.shape[0]
        if cfg.moe_dispatch == "einsum":
            y, aux, probs = _grouped_moe(cfg, gcfg, xs, router_logits, tv,
                                         train, expert_fn, group)
        else:
            g = s // group
            comp = top_k_gating_compact(
                router_logits.reshape(g, group, e), gcfg, train=train,
                token_valid=tv.reshape(g, group) if tv is not None else None)
            cap = gcfg.capacity(group, train)
            y = (moe_ffn_ragged_grouped(xs, comp, e, cap, group,
                                        expert_fn_ragged) if ragged
                 else moe_ffn_gather_grouped(xs, comp, e, cap, group,
                                             expert_fn))
            aux, probs = comp.aux_loss.mean(), comp.router_probs.reshape(s, e)
        if pad:
            y, probs, xs = y[:n], probs[:n], xs[:n]
    elif cfg.moe_dispatch == "einsum":
        gate = top_k_gating(router_logits, gcfg, train=train, token_valid=tv)
        y = moe_ffn(xs, gate.dispatch, gate.combine, expert_fn)
        aux, probs = gate.aux_loss, gate.router_probs
    else:
        comp = top_k_gating_compact(router_logits, gcfg, train=train,
                                    token_valid=tv)
        cap = gcfg.capacity(n, train)
        y = (moe_ffn_ragged(xs, comp, e, cap, expert_fn_ragged) if ragged
             else moe_ffn_gather(xs, comp, e, cap, expert_fn))
        aux, probs = comp.aux_loss, comp.router_probs
    y = y.reshape(b, t, d)
    if tp > 1:
        y = row_out(y, pctx, seq)
    if cfg.moe_use_residual:
        res = mlp_forward(cfg, p.residual_mlp, x_in)
        coef = torch.softmax((x_in @ p.coef).float(), dim=-1)
        y = y * coef[..., :1].to(y.dtype) + res * coef[..., 1:].to(res.dtype)
    return y, aux, probs


# Recomputation policies (DecoderConfig.remat_policy).  'dots' keeps the
# matmul outputs of a recomputed layer and recomputes the rest (the JAX
# `dots_with_no_batch_dims_saveable`, here every mm / bmm / addmm / int8
# product); 'moe' recomputes only the sparse-FFN block (gating, dispatch,
# expert products: the dominant activations), whatever `remat` says.
_SAVED_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default, torch.ops.aten._int_mm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_saved_context():
    """The `context_fn` of torch.utils.checkpoint that keeps matmul
    outputs (remat_policy='dots', the fused step's 'save_dots')."""
    return create_selective_checkpoint_contexts(_save_dots)


def _moe_block(cfg: DecoderConfig, p: MoEMLP, x: torch.Tensor, train: bool,
               token_valid: Optional[torch.Tensor]):
    if cfg.remat_policy == "moe" and torch.is_grad_enabled():
        return checkpoint(moe_block_forward, cfg, p, x, train, token_valid,
                          use_reentrant=False)
    return moe_block_forward(cfg, p, x, train, token_valid)


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
                kv_pos: torch.Tensor, pctx=None) -> torch.Tensor:
    """[B, H, T, S] additive bias: -slope * (q_pos - kv_pos) (the rank's
    heads under a tensor split)."""
    slopes = _alibi_slopes(cfg.num_heads, q_pos.device)
    if tensor_size(pctx) > 1:
        slopes = slopes.chunk(pctx.tensor_size)[pctx.tensor_rank]
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
    `cache.length` (in place; the caller wrote the segment row).  Under a
    tensor split the rank runs its H / tensor query and KH / tensor KV
    heads and `wo` is row-parallel; with sequence parallelism x and the
    output are the rank's T-shards (positions and segment ids are whole)."""
    pctx, tp, seq = _tp(cfg)
    if tp > 1:
        x = column_in(x, pctx, seq)
    b, t, d = x.shape
    h, kh, dh = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim

    if hasattr(p, "wqkv"):
        # fused int8 projection (quantize_decoder_int8 fuse=True): one
        # activation quantization and one wide int8 product for q|k|v (a
        # rank's slice: its q, then its k, then its v columns)
        qkv = dense(x, p.wqkv, pctx)
        q, k, v = qkv.split([h * dh, kh * dh, kh * dh], dim=-1)
    else:
        q, k, v = (dense(x, p.wq, pctx), dense(x, p.wk, pctx),
                   dense(x, p.wv, pctx))
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
        start = _write_at(cache, t)
        k_bh = k.transpose(1, 2)  # [B, KH, t, D]
        v_bh = v.transpose(1, 2)
        slot = layer_idx - cache.first_layer
        ck, cv = cache.k[slot], cache.v[slot]
        scales = None
        if cache.quantized:
            kq, ks = _quantize_kv(k_bh)
            vq, vs = _quantize_kv(v_bh)
            cks, cvs = cache.k_scale[slot], cache.v_scale[slot]
            for dst, src in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
                _write(dst, 2, start, src)
            scales = (cks, cvs)
        else:
            _write(ck, 2, start, k_bh)
            _write(cv, 2, start, v_bh)
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
        bias = (_alibi_bias(cfg, positions, positions, pctx) if cfg.alibi
                else None)
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

    out = row_dense(out.reshape(b, t, h * dh), p.wo, pctx, seq)
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
            mlp_out, aux, router_probs = _moe_block(
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
        mlp_out, aux, router_probs = _moe_block(
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
    boundaries, or also the matmul outputs with remat_policy='dots'
    (no-cache path only, as in the JAX package).  Under a tensor split the
    returned hidden is whole on every tensor rank, for the vocab-parallel
    head (its gradient is reduced over the group).  Under pipe > 1 the
    layers run as the stages of a GPipe pipeline, or with a cache or
    `scan_layers` off as the stages in turn (parallel/pipeline.py), and the
    hidden is the same on every stage.
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
        _write(cache.segment, 1, _write_at(cache, t), seg_new)

    if cache is not None and cfg.seq_shard_activations:
        # a cached call keeps the whole sequence on every tensor rank
        cfg = cfg.replace(seq_shard_activations=False)
    pctx, tp, seq = _tp(cfg)
    x = inputs_embeds
    if seq:
        # sequence parallelism: the rank's T-shard between the blocks
        x = split_seq(x, pctx)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    moe_losses: List[torch.Tensor] = []
    router_probs: List[torch.Tensor] = []
    rematted = remat and cache is None and torch.is_grad_enabled()
    if pipeline.pipe_size() > 1:
        if cache is None and cfg.scan_layers:
            # router probes are not returned under the pipeline
            x, aux_total = pipeline.pipeline_layers(
                cfg, model.layers, x, positions, segment_ids, train,
                attn_impl, remat, prefix_mask)
        else:
            x, aux_total, moe_losses, router_probs = \
                pipeline.sequential_layers(
                    cfg, model.layers, x, positions, segment_ids, cache,
                    train, attn_impl, rematted, prefix_mask)
        layers = ()
    else:
        layers = model.layers
    for i, layer in enumerate(layers):
        args = (cfg, x, positions, segment_ids, i, cache, train, attn_impl,
                prefix_mask)
        if rematted:
            ctx = ({"context_fn": dots_saved_context}
                   if cfg.remat_policy == "dots" else {})
            x, aux, probs = checkpoint(layer, *args, use_reentrant=False,
                                       **ctx)
        else:
            x, aux, probs = layer(*args)
        aux_total = aux_total + aux
        if probs is not None:
            moe_losses.append(aux)
            router_probs.append(probs)
    x = _norm(cfg, model.final_norm, x)
    if tp > 1:
        # the input of the vocab-parallel head: whole on every tensor rank
        x = column_in(x, pctx, seq)
    new_cache = cache._replace(length=cache.length + t) if cache is not None else None
    return DecoderOutput(x, aux_total, tuple(moe_losses), tuple(router_probs),
                         new_cache)


def embed(model: Decoder, cfg: DecoderConfig,
          input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings [B, T, D].  Vocab-parallel under a tensor split:
    each rank looks up the ids of its vocab rows, zeroes the rest, and the
    ranks' tables are summed (all-reduced) whole."""
    w = model.embed.embedding
    ids = input_ids.long()
    pctx = parallel_context()
    tp = tensor_size(pctx)
    if tp > 1:
        rows = (w.w_int8 if isinstance(w, Int8Weight) else w).shape[0]
        local = ids - pctx.tensor_rank * rows
        inside = (local >= 0) & (local < rows)
        ids = torch.where(inside, local, 0)
    if isinstance(w, Int8Weight):
        # int8 table (per-row scales): gather the int8 rows and their
        # scales, dequantize to the dtype `dtype_ref` carries
        tgt = w.dtype_ref.dtype if hasattr(w, "dtype_ref") else torch.bfloat16
        e = (w.w_int8[ids].float() * w.scale[ids][..., None]).to(tgt)
    else:
        e = w[ids]
    if tp > 1:
        e = reduce_out(torch.where(inside[..., None], e, 0.0).to(e.dtype),
                       pctx)
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
