"""Operation and byte counts of the work a cell requires, from the
configuration's widths and the inputs' real token counts, and the H100's
published peaks they are held against.

What depends on the decoder's layout (its linear products, attention
core, decode step and attention kernels' work) comes from the
configuration's architecture (benchmark/harness/arch/<architecture>.py);
the tower, the projector and the head are counted here.  Counts are of
multiply-adds x 2 over real tokens (no padding, no
recomputation), split by the precision the configuration computes them in:
bfloat16 products against the dense bf16 peak, int8 (W8A8) products
against the dense int8 peak.  Causal attention over n tokens counts the
n (n + 1) / 2 pairs it needs.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.harness import common

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: Dict[str, float]) -> float:
    return flops.get("bf16", 0.0) / PEAK_BF16 + flops.get("int8", 0.0) / PEAK_INT8


def add(a: Dict[str, float], b: Dict[str, float], k: float = 1.0):
    for key, v in b.items():
        a[key] = a.get(key, 0.0) + k * v
    return a


def vision_flops(cfg: dict) -> float:
    """One image through the tower's selected blocks and the projector."""
    v = cfg["vision_config"]
    d, f = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    g = v["image_size"] // p
    n = g * g + 1
    blocks = v["num_hidden_layers"] + cfg["mm_vision_select_layer"] + 1
    per_block = 2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d
    return 2 * g * g * p * p * 3 * d + blocks * per_block + projector_flops(cfg)


def projector_flops(cfg: dict) -> float:
    v = cfg["vision_config"]
    g = v["image_size"] // v["patch_size"]
    d = cfg["hidden_size"]
    return 2 * g * g * (v["hidden_size"] * d + d * d)


def _arch(cfg: dict):
    return common.architecture(cfg, "harness")


def linear_macs_per_token(cfg: dict) -> Tuple[float, float]:
    """(attention projections, FFN incl. routers and the active experts)
    multiply-adds of one token through all decoder layers."""
    return _arch(cfg).linear_macs_per_token(cfg)


def attention_core(cfg: dict, n: int) -> float:
    """QK^T and PV of causal attention over n tokens, all layers."""
    return _arch(cfg).attention_core(cfg, n)


def head_flops(cfg: dict, rows: int) -> float:
    return 2 * rows * cfg["hidden_size"] * cfg["vocab_size"]


def distill_microbatch(student: dict, teacher: dict, n: int) -> Dict[str, float]:
    """Stage 2b of one image sequence of n real tokens: the shared tower,
    both projectors, the teacher's W8A8 forward and int8 head, the
    student's forward with its int8 head, the activation gradients down
    to the projector (every layer: the projector trains), the head's
    input gradient (bf16, through the dequantized head), and the weight
    gradients of the trainable matrices (FFN, experts, routers,
    projector)."""
    out: Dict[str, float] = {"bf16": vision_flops(student)
                             + projector_flops(teacher)}
    ta, tf = linear_macs_per_token(teacher)
    add(out, {"int8": 2 * n * (ta + tf) + head_flops(teacher, n),
               "bf16": attention_core(teacher, n)})
    sa, sf = linear_macs_per_token(student)
    fwd_lin = 2 * n * (sa + sf)
    add(out, {"bf16": fwd_lin + attention_core(student, n),
               "int8": head_flops(student, n)})
    # backward: dX through every layer and the head, dW of the FFN side
    # and of the projector, twice the attention core
    add(out, {"bf16": fwd_lin + 2 * n * sf + 2 * attention_core(student, n)
               + head_flops(student, n) + projector_flops(student)})
    return out


def serve_request(cfg: dict, prompt: int, new_tokens: int) -> Dict[str, float]:
    """One image request: tower and projector, the prefill of its real
    prompt tokens with the head at the last one, then new_tokens - 1
    decode steps, each attending over its context."""
    a, f = linear_macs_per_token(cfg)
    flops = vision_flops(cfg) + 2 * prompt * (a + f) + attention_core(cfg, prompt) \
        + head_flops(cfg, 1)
    arch = _arch(cfg)
    for s in range(1, new_tokens):
        ctx = prompt + s
        flops += 2 * (a + f) + head_flops(cfg, 1) \
            + arch.decode_attention(cfg, ctx)
    return {"bf16": flops}


def attention_work(cfg: dict, n: int, kind: str) -> Tuple[float, float]:
    """(flops, bytes) of one layer's attention over one sequence of n real
    tokens: 'fwd', 'bwd' or 'decode' (one query over n cached
    positions)."""
    return _arch(cfg).attention_work(cfg, n, kind)


def roofline_seconds(flops: float, nbytes: float) -> float:
    """Least seconds of one kernel call doing `flops` over `nbytes`."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)
