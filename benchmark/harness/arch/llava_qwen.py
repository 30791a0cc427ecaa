"""The `llava_qwen` architecture on the harness's side: the Qwen1.5 decoder
of LLaVA-Qwen and LLaVA-MoD (RMSNorm, rotary embeddings, multi-head
attention with q/k/v biases, SwiGLU) with LLaVA-MoD's sparse layers
(stacked experts at `intermediate_size` and a router, on the layers
`moe_mode` picks).

* `groups`: the decoder's parameter groups, the part of the model after
  the projector, by the program's checkpoint names;
* `decoder_config`: the keyword arguments of the program's
  `DecoderConfig`;
* the counts of benchmark/harness/flops.py that depend on the decoder:
  `linear_macs_per_token`, `attention_core`, `decode_attention` and
  `attention_work`.

The reference's decoder is benchmark/reference/arch/llava_qwen.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.harness.weights import Entry, head_dim, moe_layers


def groups(cfg: dict) -> Dict[str, List[Entry]]:
    """{group: [(name, shape, kind)]} of the decoder, in order: the
    embedding, each layer, the final norm and an untied head."""
    out: Dict[str, List[Entry]] = {}
    d = cfg["hidden_size"]
    vocab, f = cfg["vocab_size"], cfg["intermediate_size"]
    h, kh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 head_dim(cfg))
    out["llm.embed"] = [("llm.embed.embedding", (vocab, d), "normal")]
    experts = set(moe_layers(cfg))
    e = cfg.get("moe", {}).get("num_experts", 0)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"llm.layers.{i}"
        ent = [(pre + ".input_norm.weight", (d,), "ones"),
               (pre + ".attn.wq", (d, h * dh), "dense"),
               (pre + ".attn.wk", (d, kh * dh), "dense"),
               (pre + ".attn.wv", (d, kh * dh), "dense"),
               (pre + ".attn.wo", (h * dh, d), "dense")]
        if cfg.get("qkv_bias", False):
            ent += [(pre + ".attn.bq", (h * dh,), "bias"),
                    (pre + ".attn.bk", (kh * dh,), "bias"),
                    (pre + ".attn.bv", (kh * dh,), "bias")]
        ent.append((pre + ".post_attn_input_norm.weight", (d,), "ones"))
        if i in experts:
            ent += [(pre + ".mlp.router", (d, e), "dense"),
                    (pre + ".mlp.experts.gate", (e, d, f), "dense"),
                    (pre + ".mlp.experts.up", (e, d, f), "dense"),
                    (pre + ".mlp.experts.down", (e, f, d), "dense")]
        else:
            ent += [(pre + ".mlp.gate", (d, f), "dense"),
                    (pre + ".mlp.up", (d, f), "dense"),
                    (pre + ".mlp.down", (f, d), "dense")]
        out[pre] = ent
    out["llm.final_norm"] = [("llm.final_norm.weight", (d,), "ones")]
    if not cfg.get("tie_word_embeddings", False):
        out["llm.lm_head"] = [("llm.lm_head.weight", (vocab, d), "normal")]
    return out


def decoder_config(cfg: dict) -> dict:
    """The program's `DecoderConfig` keyword arguments."""
    moe = cfg.get("moe") or {}
    layers = moe_layers(cfg)
    return dict(
        name=cfg["name"], vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=head_dim(cfg),
        max_position_embeddings=cfg["max_position_embeddings"],
        rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
        qkv_bias=cfg["qkv_bias"],
        tie_word_embeddings=cfg["tie_word_embeddings"],
        moe_num_experts=moe.get("num_experts", 0) if layers else 0,
        moe_top_k=moe.get("num_experts_per_tok", 2),
        moe_capacity_factor=moe.get("capacity_factor", 1.5),
        moe_eval_capacity_factor=moe.get("eval_capacity_factor", 2.0),
        moe_min_capacity=moe.get("min_capacity", 4),
        moe_layers=layers,
        moe_use_residual=moe.get("use_residual", False),
        router_aux_loss_coef=moe.get("router_aux_loss_coef", 0.01))


def linear_macs_per_token(cfg: dict) -> Tuple[float, float]:
    """(attention projections, FFN incl. routers and the active experts)
    multiply-adds of one token through all decoder layers."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 head_dim(cfg))
    layers = cfg["num_hidden_layers"]
    attn = layers * (2 * d * h * dh + 2 * d * kh * dh)
    moe = moe_layers(cfg)
    ffn = (layers - len(moe)) * 3 * d * f
    if moe:
        m = cfg["moe"]
        ffn += len(moe) * (m["num_experts_per_tok"] * 3 * d * f
                           + d * m["num_experts"])
    return attn, ffn


def attention_core(cfg: dict, n: int) -> float:
    """QK^T and PV of causal attention over n tokens, all layers."""
    h, dh = cfg["num_attention_heads"], head_dim(cfg)
    return cfg["num_hidden_layers"] * 4 * h * dh * n * (n + 1) / 2


def decode_attention(cfg: dict, ctx: int) -> float:
    """QK^T and PV of one decode step's query over `ctx` cached
    positions, all layers."""
    h, dh = cfg["num_attention_heads"], head_dim(cfg)
    return cfg["num_hidden_layers"] * 4 * h * dh * ctx


def attention_work(cfg: dict, n: int, kind: str) -> Tuple[float, float]:
    """(flops, bytes) of one layer's attention over one sequence of n real
    tokens: 'fwd' (reads q, k, v; writes o), 'bwd' (reads q, k, v, o, do;
    writes dq, dk, dv) or 'decode' (one query over n cached positions),
    bf16 tensors."""
    h, kh, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    if kind == "decode":
        return 4 * h * dh * n, 2 * (2 * n * kh * dh + 2 * h * dh)
    pairs = n * (n + 1) / 2
    if kind == "fwd":
        return 4 * h * dh * pairs, 2 * n * dh * (2 * h + 2 * kh)
    return 8 * h * dh * pairs, 2 * n * dh * (4 * h + 4 * kh)
