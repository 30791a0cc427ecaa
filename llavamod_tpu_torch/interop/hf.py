"""HF <-> port weight conversion (port of llavamod_tpu/interop/hf.py).

The converters return and take flat state dicts of the port's modules, the
JAX param-tree paths joined by '.' ('embed.embedding', 'layers.3.attn.wq',
'layers.2.mlp.experts.up', 'patch_embed.kernel', 'layers.0.kernel'),
relative to the decoder, the vision tower or the projector.  Conventions:
  * our linear weights are [in, out]; torch nn.Linear is [out, in] ->
    transpose (done in torch, on `device`, in the file's dtype);
  * embedding / lm_head stay [V, D]; stacked experts are [E, D, F];
  * conv patch embedding [D, C, p, p] -> [C*p*p, D].
Tensors keep the checkpoint's dtype unless `dtype` asks for another: the
values are those of the JAX converter, which widens every tensor to f32 on
the host (bf16 -> f32 is exact).

HF configs are read from `config.json` with `json` (no transformers):
`hf_config` fills each family's config-class defaults (`HF_CONFIG_DEFAULTS`,
copied from transformers' Qwen2/Llama/Mistral/Gemma2/Phi/StableLm/Mpt
config classes) where the JAX package relies on `AutoConfig` for them, and
keeps the reference's own `moe_llava_*` / `llava_*` model types and their
embedded `moe` block, which `AutoConfig` cannot read without the reference
code registered.
"""

from __future__ import annotations

import json
import os
import re
import types
from typing import Any, Dict, Mapping, Optional

import torch

from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.vision.vit import VisionConfig

State = Dict[str, torch.Tensor]

# HF model_types whose config + state-dict layout we can convert.  Anything
# else raises a ValueError up front instead of a KeyError mid-conversion.
SUPPORTED_MODEL_TYPES = (
    "qwen2", "llama", "mistral", "minicpm",          # llama-style layouts
    "gemma2", "phi", "stablelm", "stablelm_epoch",   # llama keys, extra flags
    "mpt", "qwen",                                   # fused-qkv layouts
)

# transformers 4.57 config-class defaults of the keys `decoder_config_from_hf`
# reads, where AutoConfig would supply them (num_key_value_heads only where
# the class default is a number rather than num_attention_heads).  minicpm,
# stablelm_epoch and qwen-1.0 have no class in transformers: their
# config.json is read as written, as the JAX package's remote-code path does.
HF_CONFIG_DEFAULTS = {
    "qwen2": dict(vocab_size=151936, hidden_size=4096,
                  intermediate_size=22016, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=32,
                  max_position_embeddings=32768, rope_theta=10000.0,
                  rms_norm_eps=1e-6, tie_word_embeddings=False),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  max_position_embeddings=2048, rope_theta=10000.0,
                  rms_norm_eps=1e-6, attention_bias=False,
                  tie_word_embeddings=False),
    "mistral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=131072, rope_theta=10000.0,
                    rms_norm_eps=1e-6, tie_word_embeddings=False,
                    sliding_window=4096),
    "gemma2": dict(vocab_size=256000, hidden_size=2304, intermediate_size=9216,
                   num_hidden_layers=26, num_attention_heads=8,
                   num_key_value_heads=4, head_dim=256,
                   max_position_embeddings=8192, rope_theta=10000.0,
                   rms_norm_eps=1e-6, attention_bias=False,
                   tie_word_embeddings=True, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=256,
                   sliding_window=4096),
    "phi": dict(vocab_size=51200, hidden_size=2048, intermediate_size=8192,
                num_hidden_layers=24, num_attention_heads=32,
                max_position_embeddings=2048, rope_theta=10000.0,
                layer_norm_eps=1e-5, partial_rotary_factor=0.5,
                tie_word_embeddings=False),
    "stablelm": dict(vocab_size=50304, hidden_size=2560,
                     intermediate_size=6912, num_hidden_layers=32,
                     num_attention_heads=32, num_key_value_heads=32,
                     max_position_embeddings=4096, rope_theta=10000,
                     layer_norm_eps=1e-5, partial_rotary_factor=0.25,
                     use_qkv_bias=False, tie_word_embeddings=False),
    "mpt": dict(vocab_size=50368, d_model=2048, n_heads=16, n_layers=24,
                expansion_ratio=4, max_seq_len=2048, layer_norm_epsilon=1e-5),
}


def base_model_type(model_type: str) -> str:
    """The reference's checkpoint model_types (llava_qwen1_5.py:46 etc.)
    map onto their base modeling layout; qwen1_5 checkpoints use the Qwen2
    modeling (reference vendored qwen1_5/modeling_qwen2.py)."""
    mt = model_type
    if mt.startswith("moe_llava_"):
        mt = mt[len("moe_llava_"):]
    elif mt.startswith("llava_"):
        mt = mt[len("llava_"):]
    return {"qwen1_5": "qwen2"}.get(mt, mt)


def hf_config(d: Mapping[str, Any]) -> types.SimpleNamespace:
    """A namespace over a config.json dict, with the family's config-class
    defaults under it."""
    mt = base_model_type(d.get("model_type", "llama"))
    return types.SimpleNamespace(**{**HF_CONFIG_DEFAULTS.get(mt, {}), **d})


def load_hf_config(model_dir: str) -> types.SimpleNamespace:
    with open(os.path.join(model_dir, "config.json")) as f:
        return hf_config(json.load(f))


def _moe_kwargs_from_hf(hf_cfg) -> dict:
    """The reference's embedded `moe` config block (llava_qwen1_5_moe.py:48-81)."""
    moe = getattr(hf_cfg, "moe", None)
    if not (isinstance(moe, dict) and moe.get("moe_enable")):
        return {}
    num_experts = moe.get("num_experts", 4)
    if isinstance(num_experts, (list, tuple)):
        num_experts = num_experts[0]
    return dict(
        moe_num_experts=int(num_experts),
        moe_top_k=int(moe.get("top_k_experts", 2)),
        moe_capacity_factor=float(moe.get("capacity_factor", 1.5)),
        moe_eval_capacity_factor=float(moe.get("eval_capacity_factor", 2.0)),
        moe_min_capacity=int(moe.get("min_capacity", 4)),
        moe_layers=tuple(moe.get("moe_layers_idx") or ()),
        moe_use_residual=bool(moe.get("use_residual", False)),
        router_aux_loss_coef=float(moe.get("router_aux_loss_coef", 0.01)),
    )


def decoder_config_from_hf(hf_cfg) -> DecoderConfig:
    """Map an HF config (a config.json dict, or a namespace from
    `hf_config`) to DecoderConfig for every family the reference vendors:
    qwen2/llama/mistral/minicpm/gemma2/phi/stablelm/mpt/qwen-1.0, including
    the reference's embedded `moe` block."""
    if isinstance(hf_cfg, Mapping):
        hf_cfg = hf_config(hf_cfg)
    mt = base_model_type(getattr(hf_cfg, "model_type", "llama"))
    kw = _moe_kwargs_from_hf(hf_cfg)

    if mt == "mpt":
        # reference mpt/configuration_mpt.py: d_model/n_heads/n_layers,
        # expansion_ratio, attn_config dict; ALiBi, LayerNorm, GELU, no rope.
        attn_cfg = getattr(hf_cfg, "attn_config", None) or {}
        d = hf_cfg.d_model
        return DecoderConfig(
            name="hf-mpt", vocab_size=hf_cfg.vocab_size, hidden_size=d,
            intermediate_size=d * getattr(hf_cfg, "expansion_ratio", 4),
            num_layers=hf_cfg.n_layers, num_heads=hf_cfg.n_heads,
            num_kv_heads=hf_cfg.n_heads,
            max_position_embeddings=getattr(hf_cfg, "max_seq_len", 2048),
            norm="layernorm",
            layernorm_eps=getattr(hf_cfg, "layer_norm_epsilon", 1e-5),
            activation="gelu", gated_mlp=False, use_rope=False,
            alibi=bool(attn_cfg.get("alibi", True)),
            tie_word_embeddings=True, **kw)

    if mt == "qwen":
        # qwen-1.0 (reference qwen/configuration_qwen.py + modeling_qwen.py):
        # fused c_attn, halved fused MLP (w1/w2), RMSNorm, NTK + logn scaling.
        return DecoderConfig(
            name="hf-qwen", vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            intermediate_size=hf_cfg.intermediate_size // 2,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            num_kv_heads=hf_cfg.num_attention_heads,
            max_position_embeddings=getattr(hf_cfg, "seq_length", 8192),
            rope_theta=getattr(hf_cfg, "rotary_emb_base", 1e4),
            rms_norm_eps=getattr(hf_cfg, "layer_norm_epsilon", 1e-6),
            qkv_bias=True,
            use_dynamic_ntk=bool(getattr(hf_cfg, "use_dynamic_ntk", True)),
            use_logn_attn=bool(getattr(hf_cfg, "use_logn_attn", True)),
            rope_seq_length=getattr(hf_cfg, "seq_length", 8192), **kw)

    if mt not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"Unsupported HF model_type {mt!r}; supported layouts: "
            f"{', '.join(SUPPORTED_MODEL_TYPES)}")

    # llama-style configs (model.layers.{i}.self_attn.* state dicts)
    if mt == "gemma2":
        kw.update(
            head_dim=getattr(hf_cfg, "head_dim", None),
            norm_offset=1.0, activation="gelu_tanh",
            attn_logit_softcap=getattr(hf_cfg, "attn_logit_softcapping", 50.0),
            final_logit_softcap=getattr(hf_cfg, "final_logit_softcapping",
                                        30.0),
            query_pre_attn_scalar=float(
                getattr(hf_cfg, "query_pre_attn_scalar", 256)),
            post_attn_norm=True, post_mlp_norm=True,
            embed_scale=hf_cfg.hidden_size ** 0.5,
            sliding_window=getattr(hf_cfg, "sliding_window", None),
            sliding_window_pattern=2)
    elif mt == "phi":
        kw.update(
            norm="layernorm",
            layernorm_eps=getattr(hf_cfg, "layer_norm_eps", 1e-5),
            activation="gelu_tanh", gated_mlp=False, parallel_block=True,
            o_bias=True, mlp_bias=True, lm_head_bias=True,
            partial_rotary_factor=getattr(hf_cfg, "partial_rotary_factor", 0.5))
    elif mt in ("stablelm", "stablelm_epoch"):
        kw.update(
            norm="layernorm",
            layernorm_eps=getattr(hf_cfg, "layer_norm_eps",
                                  getattr(hf_cfg, "norm_eps", 1e-5)),
            partial_rotary_factor=getattr(
                hf_cfg, "partial_rotary_factor",
                getattr(hf_cfg, "rope_pct", 1.0)))
    elif mt == "minicpm":
        hs = hf_cfg.hidden_size
        kw.update(
            embed_scale=float(getattr(hf_cfg, "scale_emb", 1)),
            residual_scale=(float(getattr(hf_cfg, "scale_depth", 1))
                            / hf_cfg.num_hidden_layers ** 0.5),
            logit_scale=float(getattr(hf_cfg, "dim_model_base", hs)) / hs)
    elif mt == "mistral":
        kw.setdefault("sliding_window",
                      getattr(hf_cfg, "sliding_window", None))

    qkv_bias = (mt in ("qwen2", "phi")
                or getattr(hf_cfg, "attention_bias", False)
                or getattr(hf_cfg, "use_qkv_bias", False))
    return DecoderConfig(
        name=f"hf-{mt}",
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 1e4),
        rms_norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
        qkv_bias=qkv_bias,
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        **kw,
    )


class _Reader:
    """Reads keys of a (memory-mapped, CPU) HF state dict onto `device` in
    `dtype` (default: the stored dtype); `t` gives the [in, out] transpose,
    made contiguous on the device."""

    def __init__(self, state: Mapping[str, torch.Tensor], prefix: str = "",
                 device=None, dtype=None):
        self.state, self.prefix = state, prefix
        self.device, self.dtype = device, dtype

    def has(self, key: str) -> bool:
        return self.prefix + key in self.state

    def __call__(self, key: str) -> torch.Tensor:
        x = self.state[self.prefix + key]
        return x.to(device=self.device or x.device, dtype=self.dtype or x.dtype)

    def t(self, key: str) -> torch.Tensor:
        return self(key).t().contiguous()

    def norm(self, out: State, ours: str, key: str) -> None:
        """Norm params; the bias when the checkpoint has one (stablelm/phi
        LayerNorm; MPT/qwen/llama norms are weight-only)."""
        out[ours + ".weight"] = self(key + ".weight")
        if self.has(key + ".bias"):
            out[ours + ".bias"] = self(key + ".bias")


def decoder_params_from_hf(state: Mapping[str, torch.Tensor],
                           cfg: DecoderConfig, prefix: str = "", device=None,
                           dtype=None) -> State:
    """Convert an HF CausalLM state dict to the decoder's state dict.

    Dispatches on the state-dict layout: llama-style `model.layers.*`
    (qwen2/llama/mistral/minicpm + gemma2/phi/stablelm variants via cfg
    flags), qwen-1.0 `transformer.h.*` fused c_attn, and MPT
    `transformer.blocks.*` fused Wqkv.  Unknown layouts raise ValueError.
    """
    g = _Reader(state, prefix, device, dtype)
    if g.has("transformer.h.0.attn.c_attn.weight"):
        return _decoder_params_from_hf_qwen_v1(g, cfg)
    if g.has("transformer.blocks.0.attn.Wqkv.weight"):
        return _decoder_params_from_hf_mpt(g, cfg)
    if not g.has("model.layers.0.input_layernorm.weight"):
        known = sorted({k.split(".")[0] for k in state})[:8]
        raise ValueError(
            "Unrecognized HF state-dict layout (top-level keys "
            f"{known}); supported model types: "
            f"{', '.join(SUPPORTED_MODEL_TYPES)}")
    return _decoder_params_from_hf_llama(g, cfg)


def _decoder_params_from_hf_llama(g: _Reader, cfg: DecoderConfig) -> State:
    """llama-style layouts: qwen2/llama/mistral/minicpm, plus phi (parallel
    block, `dense`/`fc1/fc2` names, reference phi/modeling_phi.py:203-265),
    gemma2 (4 norms/layer, reference gemma2/modeling_gemma2.py:537-542), and
    stablelm (LayerNorm biases, stablelm/modeling_stablelm_epoch.py:491-497)."""
    is_phi = cfg.parallel_block
    out: State = {"embed.embedding": g("model.embed_tokens.weight")}
    g.norm(out, "final_norm", "model.final_layernorm"
           if g.has("model.final_layernorm.weight") else "model.norm")
    o_name = "self_attn.dense" if is_phi else "self_attn.o_proj"
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.", f"layers.{i}."
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
            out[q + "attn." + ours] = g.t(p + f"self_attn.{hf}.weight")
        out[q + "attn.wo"] = g.t(p + o_name + ".weight")
        if cfg.qkv_bias:
            for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
                out[q + "attn." + ours] = g(p + f"self_attn.{hf}.bias")
        if cfg.o_bias:
            out[q + "attn.bo"] = g(p + o_name + ".bias")
        if g.has(p + "mlp.deepspeed_moe.gate.wg.weight"):
            # reference MoE checkpoint (deepspeed.moe layer naming,
            # llava_qwen1_5_moe.py:534-546 / train.py:549-557 save flavor)
            ex = p + "mlp.deepspeed_moe.experts.deepspeed_experts."
            e = 0
            while g.has(ex + f"{e}.up_proj.weight"):
                e += 1
            out[q + "mlp.router"] = g.t(p + "mlp.deepspeed_moe.gate.wg.weight")
            for ours, hf in (("gate", "gate_proj"), ("up", "up_proj"),
                             ("down", "down_proj")):
                out[q + "mlp.experts." + ours] = torch.stack(
                    [g.t(ex + f"{j}.{hf}.weight") for j in range(e)])
            if g.has(p + "mlp.mlp.up_proj.weight"):  # residual
                for ours, hf in (("gate", "gate_proj"), ("up", "up_proj"),
                                 ("down", "down_proj")):
                    out[q + "mlp.residual_mlp." + ours] = g.t(
                        p + f"mlp.mlp.{hf}.weight")
                out[q + "mlp.coef"] = g.t(p + "mlp.coefficient.weight")
        elif is_phi:
            # phi MLP: fc1/fc2 with biases, no gate
            out[q + "mlp.up"] = g.t(p + "mlp.fc1.weight")
            out[q + "mlp.down"] = g.t(p + "mlp.fc2.weight")
            if cfg.mlp_bias:
                out[q + "mlp.up_bias"] = g(p + "mlp.fc1.bias")
                out[q + "mlp.down_bias"] = g(p + "mlp.fc2.bias")
        else:
            out[q + "mlp.up"] = g.t(p + "mlp.up_proj.weight")
            out[q + "mlp.down"] = g.t(p + "mlp.down_proj.weight")
            if cfg.gated_mlp:
                out[q + "mlp.gate"] = g.t(p + "mlp.gate_proj.weight")
        g.norm(out, q + "input_norm", p + "input_layernorm")
        if cfg.post_attn_norm:
            # gemma2: post_attention_layernorm normalizes the attn OUTPUT;
            # pre_feedforward_layernorm is the pre-MLP norm
            # (reference gemma2/modeling_gemma2.py:570-598)
            g.norm(out, q + "post_attn_norm", p + "post_attention_layernorm")
            g.norm(out, q + "post_attn_input_norm",
                   p + "pre_feedforward_layernorm")
        elif not cfg.parallel_block:
            g.norm(out, q + "post_attn_input_norm",
                   p + "post_attention_layernorm")
        if cfg.post_mlp_norm:
            g.norm(out, q + "post_mlp_norm", p + "post_feedforward_layernorm")
    if not cfg.tie_word_embeddings and g.has("lm_head.weight"):
        out["lm_head.weight"] = g("lm_head.weight")
        if cfg.lm_head_bias and g.has("lm_head.bias"):
            out["lm_head.bias"] = g("lm_head.bias")
    return out


def _split3(w: torch.Tensor, d: int):
    return w[:d], w[d:2 * d], w[2 * d:]


def _decoder_params_from_hf_qwen_v1(g: _Reader, cfg: DecoderConfig) -> State:
    """qwen-1.0 layout (reference qwen/modeling_qwen.py): fused
    `attn.c_attn` [3D, D] weight + [3D] bias split into q/k/v (:269,416-418),
    MLP halves w1=up, w2=gate — `intermediate = w1(x) * silu(w2(x))`
    (:570-575) — RMSNorm ln_1/ln_2, transformer.wte embedding."""
    d = cfg.hidden_size
    out: State = {"embed.embedding": g("transformer.wte.weight")}
    g.norm(out, "final_norm", "transformer.ln_f")
    for i in range(cfg.num_layers):
        p, q = f"transformer.h.{i}.", f"layers.{i}."
        w = _split3(g(p + "attn.c_attn.weight"), d)   # [3D, D] torch layout
        b = _split3(g(p + "attn.c_attn.bias"), d)     # [3D]
        for j, n in enumerate("qkv"):
            out[q + f"attn.w{n}"] = w[j].t().contiguous()
            out[q + f"attn.b{n}"] = b[j].contiguous()
        out[q + "attn.wo"] = g.t(p + "attn.c_proj.weight")
        out[q + "mlp.up"] = g.t(p + "mlp.w1.weight")
        out[q + "mlp.gate"] = g.t(p + "mlp.w2.weight")
        out[q + "mlp.down"] = g.t(p + "mlp.c_proj.weight")
        g.norm(out, q + "input_norm", p + "ln_1")
        g.norm(out, q + "post_attn_input_norm", p + "ln_2")
    if g.has("lm_head.weight"):
        out["lm_head.weight"] = g("lm_head.weight")
    return out


def _decoder_params_from_hf_mpt(g: _Reader, cfg: DecoderConfig) -> State:
    """MPT layout (reference mpt/attention.py:169-189, blocks.py:12-40):
    fused `attn.Wqkv` [3D, D] split at (D, 2D), `attn.out_proj`,
    `ffn.up_proj/down_proj`, weight-only LayerNorms norm_1/norm_2/norm_f,
    tied `transformer.wte` head."""
    d = cfg.hidden_size
    out: State = {"embed.embedding": g("transformer.wte.weight")}
    g.norm(out, "final_norm", "transformer.norm_f")
    for i in range(cfg.num_layers):
        p, q = f"transformer.blocks.{i}.", f"layers.{i}."
        w = _split3(g(p + "attn.Wqkv.weight"), d)    # [3D, D]
        for j, n in enumerate("qkv"):
            out[q + f"attn.w{n}"] = w[j].t().contiguous()
        out[q + "attn.wo"] = g.t(p + "attn.out_proj.weight")
        if g.has(p + "attn.Wqkv.bias"):
            b = _split3(g(p + "attn.Wqkv.bias"), d)
            for j, n in enumerate("qkv"):
                out[q + f"attn.b{n}"] = b[j].contiguous()
        out[q + "mlp.up"] = g.t(p + "ffn.up_proj.weight")
        out[q + "mlp.down"] = g.t(p + "ffn.down_proj.weight")
        if g.has(p + "ffn.up_proj.bias"):
            out[q + "mlp.up_bias"] = g(p + "ffn.up_proj.bias")
            out[q + "mlp.down_bias"] = g(p + "ffn.down_proj.bias")
        g.norm(out, q + "input_norm", p + "norm_1")
        g.norm(out, q + "post_attn_input_norm", p + "norm_2")
    return out


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def _norm_to_hf(out: State, key: str, state: Mapping[str, torch.Tensor],
                ours: str) -> None:
    out[key + ".weight"] = state[ours + ".weight"]
    if ours + ".bias" in state:
        out[key + ".bias"] = state[ours + ".bias"]


def decoder_params_to_hf(state: Mapping[str, torch.Tensor],
                         cfg: DecoderConfig) -> State:
    """Inverse of decoder_params_from_hf, from the decoder's state dict.
    The target layout is inferred from cfg flags (alibi -> MPT, logn/NTK ->
    qwen-1.0, parallel_block -> phi, post-sublayer norms -> gemma2, else
    llama-style).  MoE layers use the reference's DeepSpeed-MoE key naming
    so exported checkpoints load in the reference (EvalLLaVAMoD*
    reconstruction, llava_qwen1_5_moe.py:629-681)."""
    if cfg.alibi and not cfg.use_rope:
        return _decoder_params_to_hf_fused(state, cfg, "mpt")
    if cfg.use_logn_attn or cfg.use_dynamic_ntk:
        return _decoder_params_to_hf_fused(state, cfg, "qwen")

    is_phi = cfg.parallel_block
    o_name = "self_attn.dense" if is_phi else "self_attn.o_proj"
    out: State = {"model.embed_tokens.weight": state["embed.embedding"]}
    _norm_to_hf(out, "model.final_layernorm" if is_phi else "model.norm",
                state, "final_norm")
    names = {"gate_proj": "gate", "up_proj": "up", "down_proj": "down"}
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.", f"layers.{i}."
        _norm_to_hf(out, p + "input_layernorm", state, q + "input_norm")
        if cfg.post_attn_norm:
            _norm_to_hf(out, p + "post_attention_layernorm", state,
                        q + "post_attn_norm")
            _norm_to_hf(out, p + "pre_feedforward_layernorm", state,
                        q + "post_attn_input_norm")
        elif not is_phi:
            _norm_to_hf(out, p + "post_attention_layernorm", state,
                        q + "post_attn_input_norm")
        if cfg.post_mlp_norm:
            _norm_to_hf(out, p + "post_feedforward_layernorm", state,
                        q + "post_mlp_norm")
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
            out[p + f"self_attn.{hf}.weight"] = _t(state[q + "attn." + ours])
        out[p + o_name + ".weight"] = _t(state[q + "attn.wo"])
        if q + "attn.bq" in state:
            for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
                out[p + f"self_attn.{hf}.bias"] = state[q + "attn." + ours]
        if q + "attn.bo" in state:
            out[p + o_name + ".bias"] = state[q + "attn.bo"]
        m = q + "mlp."
        if m + "router" in state:
            out[p + "mlp.deepspeed_moe.gate.wg.weight"] = _t(state[m + "router"])
            for hf_name, ours in names.items():
                if m + "experts." + ours not in state:
                    continue
                stacked = state[m + "experts." + ours]
                for j in range(stacked.shape[0]):
                    out[p + "mlp.deepspeed_moe.experts.deepspeed_experts"
                        f".{j}.{hf_name}.weight"] = _t(stacked[j])
            if m + "residual_mlp.up" in state:
                for hf_name, ours in names.items():
                    out[p + f"mlp.mlp.{hf_name}.weight"] = _t(
                        state[m + "residual_mlp." + ours])
                out[p + "mlp.coefficient.weight"] = _t(state[m + "coef"])
        elif is_phi:
            out[p + "mlp.fc1.weight"] = _t(state[m + "up"])
            out[p + "mlp.fc2.weight"] = _t(state[m + "down"])
            if m + "up_bias" in state:
                out[p + "mlp.fc1.bias"] = state[m + "up_bias"]
                out[p + "mlp.fc2.bias"] = state[m + "down_bias"]
        else:
            if m + "gate" in state:
                out[p + "mlp.gate_proj.weight"] = _t(state[m + "gate"])
            out[p + "mlp.up_proj.weight"] = _t(state[m + "up"])
            out[p + "mlp.down_proj.weight"] = _t(state[m + "down"])
    if "lm_head.weight" in state:
        out["lm_head.weight"] = state["lm_head.weight"]
        if "lm_head.bias" in state:
            out["lm_head.bias"] = state["lm_head.bias"]
    return out


def _decoder_params_to_hf_fused(state: Mapping[str, torch.Tensor],
                                cfg: DecoderConfig, layout: str) -> State:
    """qwen-1.0 (`transformer.h.*`, c_attn, w1/w2) and MPT
    (`transformer.blocks.*`, Wqkv, ffn) exports."""
    qwen = layout == "qwen"
    out: State = {"transformer.wte.weight": state["embed.embedding"]}
    _norm_to_hf(out, "transformer.ln_f" if qwen else "transformer.norm_f",
                state, "final_norm")
    for i in range(cfg.num_layers):
        q = f"layers.{i}."
        p = f"transformer.h.{i}." if qwen else f"transformer.blocks.{i}."
        _norm_to_hf(out, p + ("ln_1" if qwen else "norm_1"), state,
                    q + "input_norm")
        _norm_to_hf(out, p + ("ln_2" if qwen else "norm_2"), state,
                    q + "post_attn_input_norm")
        a = q + "attn."
        qkv = p + ("attn.c_attn" if qwen else "attn.Wqkv")
        out[qkv + ".weight"] = torch.cat(
            [_t(state[a + w]) for w in ("wq", "wk", "wv")], dim=0)
        if a + "bq" in state:
            out[qkv + ".bias"] = torch.cat(
                [state[a + b] for b in ("bq", "bk", "bv")], dim=0)
        out[p + ("attn.c_proj" if qwen else "attn.out_proj") + ".weight"] = \
            _t(state[a + "wo"])
        m = q + "mlp."
        if qwen:
            out[p + "mlp.w1.weight"] = _t(state[m + "up"])
            out[p + "mlp.w2.weight"] = _t(state[m + "gate"])
            out[p + "mlp.c_proj.weight"] = _t(state[m + "down"])
        else:
            out[p + "ffn.up_proj.weight"] = _t(state[m + "up"])
            out[p + "ffn.down_proj.weight"] = _t(state[m + "down"])
            if m + "up_bias" in state:
                out[p + "ffn.up_proj.bias"] = state[m + "up_bias"]
                out[p + "ffn.down_proj.bias"] = state[m + "down_bias"]
    if qwen and "lm_head.weight" in state:
        out["lm_head.weight"] = state["lm_head.weight"]
    return out


# Blip2Model submodule key map (reference multimodal_projector/qformer.py:
# 9-24 wraps transformers' Blip2QFormerModel as `qformer`, with proj_in /
# proj_out nn.Sequentials and the query_tokens parameter): ours inside a
# layer -> the HF key inside `qformer.encoder.layer.{i}.`
_QF_DENSE_MAP = (
    ("self_attn.q", "attention.attention.query"),
    ("self_attn.k", "attention.attention.key"),
    ("self_attn.v", "attention.attention.value"),
    ("self_attn.o", "attention.output.dense"),
    ("cross_attn.q", "crossattention.attention.query"),
    ("cross_attn.k", "crossattention.attention.key"),
    ("cross_attn.v", "crossattention.attention.value"),
    ("cross_attn.o", "crossattention.output.dense"),
    ("mlp.fc1", "intermediate_query.dense"),
    ("mlp.fc2", "output_query.dense"),
)
_QF_LN_MAP = (
    ("ln_self", "attention.output.LayerNorm"),
    ("ln_cross", "crossattention.output.LayerNorm"),
    ("ln_mlp", "output_query.LayerNorm"),
)
_QF_SEQ = (("fc1", 0), ("fc2", 2))     # nn.Sequential: Linear, GELU, Linear


def _qformer_params_to_hf(state: Mapping[str, torch.Tensor],
                          base: str) -> State:
    out: State = {}
    for name, idx in _QF_SEQ:
        for side in ("proj_in", "proj_out"):
            out[f"{base}{side}.{idx}.weight"] = _t(state[f"{side}.{name}.kernel"])
            out[f"{base}{side}.{idx}.bias"] = state[f"{side}.{name}.bias"]
    out[base + "query_tokens"] = state["queries"][None]       # [1, Q, W]
    out[base + "qformer.layernorm.weight"] = state["ln_embed.weight"]
    out[base + "qformer.layernorm.bias"] = state["ln_embed.bias"]
    n_layers = len({k.split(".")[1] for k in state if k.startswith("layers.")})
    for i in range(n_layers):
        lp, q = f"{base}qformer.encoder.layer.{i}.", f"layers.{i}."
        for ours, hf_key in _QF_DENSE_MAP:
            out[lp + hf_key + ".weight"] = _t(state[q + ours + ".kernel"])
            out[lp + hf_key + ".bias"] = state[q + ours + ".bias"]
        for ours, hf_key in _QF_LN_MAP:
            out[lp + hf_key + ".weight"] = state[q + ours + ".weight"]
            out[lp + hf_key + ".bias"] = state[q + ours + ".bias"]
    return out


def _qformer_params_from_hf(g: "_Reader", num_layers: int) -> State:
    out: State = {}
    for name, idx in _QF_SEQ:
        for side in ("proj_in", "proj_out"):
            out[f"{side}.{name}.kernel"] = g.t(f"{side}.{idx}.weight")
            out[f"{side}.{name}.bias"] = g(f"{side}.{idx}.bias")
    out["queries"] = g("query_tokens")[0]
    out["ln_embed.weight"] = g("qformer.layernorm.weight")
    out["ln_embed.bias"] = g("qformer.layernorm.bias")
    for i in range(num_layers):
        lp, q = f"qformer.encoder.layer.{i}.", f"layers.{i}."
        for ours, hf_key in _QF_DENSE_MAP:
            out[q + ours + ".kernel"] = g.t(lp + hf_key + ".weight")
            out[q + ours + ".bias"] = g(lp + hf_key + ".bias")
        for ours, hf_key in _QF_LN_MAP:
            out[q + ours + ".weight"] = g(lp + hf_key + ".weight")
            out[q + ours + ".bias"] = g(lp + hf_key + ".bias")
    return out


def projector_params_to_hf(state: Mapping[str, torch.Tensor],
                           projector_type: str = "mlp2x_gelu",
                           prefix: str = "model.mm_projector.") -> State:
    """Inverse of projector_params_from_hf (reference key layout).  The
    simple projector has no reference layout: it raises, as in the JAX
    package (its mm_projector.bin uses the tree layout)."""
    if re.match(r"^(cheap_)?qformer\d+_\d+$", projector_type):
        return _qformer_params_to_hf(state, prefix + "image_spatial_proj.")
    if projector_type == "linear":
        return {prefix + "image_spatial_proj.weight": _t(state["kernel"]),
                prefix + "image_spatial_proj.bias": state["bias"]}
    m = re.match(r"^(pool_)?mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise NotImplementedError(
            f"HF export for projector '{projector_type}' not implemented")
    # nn.Sequential: Linear, GELU, Linear, ...; Pool_Block (reference
    # pool_block.py:8-27) nests it under 'block.' (AvgPool2d has no params)
    sub = "image_spatial_proj." + ("block." if m.group(1) else "")
    out: State = {}
    for j in range(int(m.group(2))):
        out[prefix + f"{sub}{2 * j}.weight"] = _t(state[f"layers.{j}.kernel"])
        out[prefix + f"{sub}{2 * j}.bias"] = state[f"layers.{j}.bias"]
    return out


def projector_params_from_hf(state: Mapping[str, torch.Tensor],
                             projector_type: str = "mlp2x_gelu", device=None,
                             dtype=None) -> State:
    """Convert a reference mm_projector checkpoint (mm_projector.bin keys
    like 'model.mm_projector.image_spatial_proj.0.weight'; the Q-Former's
    Blip2Model keys)."""
    cleaned = {}
    for k, v in state.items():
        k = k.replace("model.mm_projector.", "").replace("mm_projector.", "")
        cleaned[k.replace("image_spatial_proj.", "")] = v
    g = _Reader(cleaned, "", device, dtype)
    if projector_type == "linear":
        return {"kernel": g.t("weight"), "bias": g("bias")}
    m = re.match(r"^(cheap_)?qformer(\d+)_\d+$", projector_type)
    if m:
        return _qformer_params_from_hf(g, int(m.group(2)))
    m = re.match(r"^(pool_)?mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise NotImplementedError(
            f"HF import for projector '{projector_type}' not implemented")
    # Pool_Block nests the Sequential under 'block.' (pool_block.py:18);
    # reference nn.Sequential indices: 0, 2, 4 ... (GELU between)
    sub = "block." if m.group(1) else ""
    out: State = {}
    for j in range(int(m.group(2))):
        out[f"layers.{j}.kernel"] = g.t(f"{sub}{2 * j}.weight")
        out[f"layers.{j}.bias"] = g(f"{sub}{2 * j}.bias")
    return out


def vision_params_from_hf(state: Mapping[str, torch.Tensor], cfg: VisionConfig,
                          prefix: str = "vision_model.", device=None,
                          dtype=None) -> State:
    """Convert an HF CLIPVisionModel / SiglipVisionModel state dict.

    The registered CLIP-ViT-L/336 config sets `patch_bias` (the JAX
    package's VisionConfig default), but HF CLIP's patch convolution has no
    bias, which the JAX converter then fails to find: a bias the checkpoint
    lacks is taken as zeros here, the same function."""
    g = _Reader(state, prefix, device, dtype)
    patch_w = g("embeddings.patch_embedding.weight")     # [D, C, p, p]
    d = patch_w.shape[0]
    out: State = {"patch_embed.kernel": patch_w.reshape(d, -1).t().contiguous(),
                  "pos_embed": g("embeddings.position_embedding.weight")}
    if cfg.patch_bias:
        out["patch_embed.bias"] = (
            g("embeddings.patch_embedding.bias")
            if g.has("embeddings.patch_embedding.bias")
            else torch.zeros(d, dtype=patch_w.dtype, device=patch_w.device))
    if cfg.use_class_token:
        out["class_token"] = g("embeddings.class_embedding").reshape(-1)
    if cfg.use_pre_layernorm:
        # HF CLIP spells it "pre_layrnorm"
        key = "pre_layrnorm" if g.has("pre_layrnorm.weight") else "pre_layernorm"
        g.norm(out, "pre_ln", key)
    g.norm(out, "post_ln", "post_layernorm")

    for i in range(cfg.num_layers):
        p, q = f"encoder.layers.{i}.", f"layers.{i}."
        g.norm(out, q + "ln1", p + "layer_norm1")
        g.norm(out, q + "ln2", p + "layer_norm2")
        for ours, hf in (("attn.q", "self_attn.q_proj"),
                         ("attn.k", "self_attn.k_proj"),
                         ("attn.v", "self_attn.v_proj"),
                         ("attn.o", "self_attn.out_proj"),
                         ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            out[q + ours + ".kernel"] = g.t(p + hf + ".weight")
            out[q + ours + ".bias"] = g(p + hf + ".bias")
    return out


def export_hf_llava(output_dir: str, cfg, state: Mapping[str, torch.Tensor]
                    ) -> str:
    """Write a reference-consumable HF checkpoint from a Llava state dict
    (`model.state_dict()`): config.json (qwen2-style llava fields + the moe
    block the reference embeds in its config, llava_qwen1_5_moe.py:48-81)
    and pytorch_model.bin (decoder + mm_projector keys, in the model's
    dtype; the frozen tower is referenced by name, exactly like the
    reference's saved checkpoints)."""
    llm = cfg.llm
    hf_cfg = {
        "architectures": ["LLaVAMoDQwen1_5ForCausalLM" if llm.is_moe
                          else "LlavaQWen1_5ForCausalLM"],
        "model_type": "qwen2",
        "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_layers,
        "num_attention_heads": llm.num_heads,
        "num_key_value_heads": llm.num_kv_heads,
        "max_position_embeddings": llm.max_position_embeddings,
        "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "torch_dtype": "bfloat16",
        "mm_image_tower": cfg.vision.name,
        "mm_projector_type": cfg.projector_type,
        "mm_vision_select_layer": cfg.select_layer,
        "mm_vision_select_feature": cfg.select_feature,
        "image_aspect_ratio": cfg.image_aspect_ratio,
    }
    if llm.is_moe:
        hf_cfg["moe"] = {
            "moe_enable": True,
            "moe_mode": "custom",
            "moe_layers_idx": list(llm.moe_layers),
            "num_experts": [llm.moe_num_experts] * len(llm.moe_layers),
            "top_k_experts": llm.moe_top_k,
            "capacity_factor": llm.moe_capacity_factor,
            "eval_capacity_factor": llm.moe_eval_capacity_factor,
            "min_capacity": llm.moe_min_capacity,
            "use_residual": llm.moe_use_residual,
            "router_aux_loss_coef": llm.router_aux_loss_coef,
            "ep_size": 1,
            "train_modules": [],
        }
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as fh:
        json.dump(hf_cfg, fh, indent=2)

    out = decoder_params_to_hf(pick(state, "llm"), llm)
    proj = pick(state, "projector")
    if proj:
        out.update(projector_params_to_hf(proj, cfg.projector_type))
    # every tensor its own contiguous host copy: a view would save its
    # whole storage
    torch.save({k: v.detach().to("cpu", copy=True).contiguous()
                for k, v in out.items()},
               os.path.join(output_dir, "pytorch_model.bin"))
    return output_dir


def pick(state: Mapping[str, torch.Tensor], name: str) -> State:
    """The entries of one group ('llm', 'projector', 'vision') of a Llava
    state dict, without the group's prefix."""
    n = len(name) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(name + ".")}


def prefixed(name: str, state: Optional[Mapping[str, torch.Tensor]]) -> State:
    return {f"{name}.{k}": v for k, v in (state or {}).items()}
