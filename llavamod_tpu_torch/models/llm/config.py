"""Decoder configuration (port of llavamod_tpu/models/llm/config.py).

Re-declared here rather than imported: the port imports nothing of the JAX
package.  Fields, defaults and derived properties are identical;
tests/test_torch_config.py holds them to the JAX dataclass field by field.
The parallelism and compile-strategy fields are kept for config-file
compatibility (llavamod_config.json) and are ignored by the eager PyTorch
forward, `remat_policy` excepted (models/llm/decoder.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from llavamod_tpu_torch.utils.registry import Registry


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str = "decoder"
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: Optional[int] = None          # defaults to hidden//heads
    max_position_embeddings: int = 32768
    rope_theta: float = 1e6
    partial_rotary_factor: float = 1.0       # phi=0.5, stablelm=0.25
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    rms_norm_eps: float = 1e-6
    norm_offset: float = 0.0                 # gemma: weight is (1 + w)
    activation: str = "silu"                 # silu | gelu | gelu_tanh
    gated_mlp: bool = True                   # SwiGLU-style gate*up
    qkv_bias: bool = False                   # qwen1.5/qwen2: True
    o_bias: bool = False
    mlp_bias: bool = False
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    query_pre_attn_scalar: Optional[float] = None  # gemma2 scale override
    post_attn_norm: bool = False             # gemma2 post-sublayer norms
    post_mlp_norm: bool = False
    parallel_block: bool = False             # phi: attn and mlp in parallel
    tie_word_embeddings: bool = False
    lm_head_bias: bool = False               # phi-2: lm_head has a bias
    embed_scale: Optional[float] = None      # gemma: sqrt(hidden); minicpm: scale_emb
    residual_scale: Optional[float] = None   # minicpm mup sublayer scale
    logit_scale: Optional[float] = None      # minicpm mup pre-head scale
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1          # gemma2: every 2nd layer global
    layernorm_eps: float = 1e-5
    use_rope: bool = True                    # mpt: False (ALiBi only)
    alibi: bool = False                      # mpt: True
    use_dynamic_ntk: bool = False            # qwen-1.0 NTK-aware rope rescale
    use_logn_attn: bool = False              # qwen-1.0 log_n query scaling
    rope_seq_length: int = 2048              # training context they anchor to

    # --- MoE block (populated after sparse upcycling; None = dense) ---
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    moe_eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 4
    moe_layers: Tuple[int, ...] = ()
    moe_use_residual: bool = False
    router_aux_loss_coef: float = 0.01
    moe_gating_group_size: int = 0           # 0 = gate all tokens at once
    moe_dispatch: str = "gather"             # gather | ragged | einsum

    # --- parallelism / compile strategy (JAX-only; kept for config I/O) ---
    seq_shard_activations: bool = False
    pipeline_microbatches: int = 0
    scan_layers: bool = True
    scan_layers_decode: bool = False
    scan_unroll: int = 1
    remat_policy: str = "none"               # none | dots | moe

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0 and len(self.moe_layers) > 0

    def replace(self, **kw) -> "DecoderConfig":
        return dataclasses.replace(self, **kw)


llm_configs: Registry[DecoderConfig] = Registry("llm config")


def _reg(cfg: DecoderConfig, *aliases: str) -> DecoderConfig:
    llm_configs.register(cfg.name, cfg, aliases=tuple(aliases))
    return cfg


QWEN2_0_5B = _reg(DecoderConfig(
    name="qwen2-0.5b", vocab_size=151936, hidden_size=896,
    intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
    rope_theta=1e6, rms_norm_eps=1e-6, qkv_bias=True,
    tie_word_embeddings=True), "qwen2_0_5b")

QWEN1_5_1_8B = _reg(DecoderConfig(
    name="qwen1.5-1.8b", vocab_size=151936, hidden_size=2048,
    intermediate_size=5504, num_layers=24, num_heads=16, num_kv_heads=16,
    rope_theta=1e6, rms_norm_eps=1e-6, qkv_bias=True), "qwen1_5_1_8b")

QWEN1_5_7B = _reg(DecoderConfig(
    name="qwen1.5-7b", vocab_size=151936, hidden_size=4096,
    intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
    rope_theta=1e6, rms_norm_eps=1e-6, qkv_bias=True), "qwen1_5_7b")


def tiny_config(**kw) -> DecoderConfig:
    """A small config for tests/CI."""
    base = dict(name="tiny", vocab_size=512, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, max_position_embeddings=512, rope_theta=1e4,
                qkv_bias=True)
    base.update(kw)
    return DecoderConfig(**base)


def moe_layer_indices(moe_mode: str, num_layers: int) -> Tuple[int, ...]:
    """Layer selection per moe_mode (llavamod_tpu/models/llm/upcycle.py)."""
    if moe_mode == "first_half":
        return tuple(range(num_layers // 2))
    if moe_mode == "second_half":
        return tuple(range(num_layers // 2, num_layers))
    if moe_mode == "sparse":
        return tuple(range(num_layers))[::2]
    if moe_mode == "dense":
        return tuple(range(num_layers))
    raise NotImplementedError(f"unknown moe_mode {moe_mode!r}")
