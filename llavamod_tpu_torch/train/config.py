"""Training configuration (port of llavamod_tpu/train/config.py).

Re-declared with the same fields and defaults as the JAX dataclass
(tests/test_torch_config.py holds them field by field), so a recipe reads
the same in both packages.  Fields of JAX-only mechanisms (the fused
backward step, Adafactor) are kept for that reason; the port's steps raise
on the ones they do not run yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # --- optimization ---
    optimizer: str = "adamw"                  # adamw | adafactor
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None   # separate LR for the projector
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"               # cosine | linear | constant
    total_steps: int = 1000
    grad_accum_steps: int = 1
    seed: int = 42

    # --- stage / trainable selection ---
    stage: str = "pretrain"  # pretrain | finetune | align | dpo
    tune_mm_mlp_adapter: bool = False          # stage-1: projector only
    freeze_mm_mlp_adapter: bool = False
    train_modules: Tuple[str, ...] = ()        # substrings; empty = all of llm
    moe_finetune: bool = False

    # --- distillation (align) ---
    align_loss_type: str = "only_kd"           # only_kd | kd_lm
    distill_all_tokens: bool = False
    moe_loss_enable: bool = True
    kd_vocab_limit: Optional[int] = None       # e.g. 151936 (qwen shared prefix)

    # --- preference (dpo) ---
    dpo_beta: float = 0.1
    dpo_loss_type: str = "kto_pair"            # sigmoid|hinge|ipo|kto_pair
    dpo_label_smoothing: float = 0.0
    reference_free: bool = False

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True                         # per-layer recompute
    fused_remat: str = "repeat"                # fused step (not ported yet)
    fused_teacher_chunks: int = -1
    fused_bwd_microbatches: int = -1
    fused_fwd_chunks: int = -1
    grad_row_chunks: int = 1                   # in-step row chunks (pretrain)
    vocab_chunk: int = 2048
    attn_impl: str = "auto"                    # auto | flash | xla
    share_vision_tower: bool = True            # one frozen tower per step
    student_head_quant: bool = False           # int8 frozen student head
    kd_int8_dh: bool = False
    kd_stream_dh: bool = False
    student_body_quant: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
