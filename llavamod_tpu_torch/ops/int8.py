"""The W8A8 building blocks: dynamic per-row int8 activation quantization
and the int8 x int8 -> int32 product.

The JAX package computes its W8A8 matmuls in plain XLA, outside Pallas
(llavamod_tpu/models/llm/decoder.py `_act_quant_rows`, `dense_int8`;
ops/losses.py `_rowquant`): `jax.lax.dot_general` of int8 operands with
`preferred_element_type=int32`.  The port takes the card's library int8
GEMM for that product, `torch._int_mm` (cuBLASLt, int32 accumulation).  It
refuses an A operand of 16 rows or fewer and K or N that are not multiples
of 8; decode batches and small expert capacities have few rows, so
`int8_matmul` pads A with zero rows (which contribute exact zeros) and
slices them off.  Any other shape `_int_mm` refuses raises: the product is
never dequantized to a float matmul on the card.  On the CPU the same
product is the plain int32 matmul.

The product is exact (int32 sums of int8 products; |sum| < 2^31 for
K < 133,000), so the card's result equals the f64 product bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

# torch._int_mm on CUDA takes an A operand of more than 16 rows
_MIN_ROWS = 17


def act_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row (last-axis) int8 quantization:
    (int8 values, f32 scales [..., 1]) with scale = max(amax / 127, 1e-8),
    q = clip(round(x / scale), -127, 127).  torch.round rounds half to even,
    as jnp.round does."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact.

    On the card: `torch._int_mm`, with A padded by zero rows up to 17 when
    M <= 16.  K and N must be multiples of 8 there (every model width is).
    `b` may be a transposed view: cuBLASLt reads a row- or column-major
    operand in place, without a copy."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"torch._int_mm needs K and N that are multiples of "
                         f"8; got M={m} K={k} N={n}")
    if m < _MIN_ROWS:
        pad = a.new_zeros((_MIN_ROWS - m, k))
        return torch._int_mm(torch.cat([a, pad]), b)[:m]
    return torch._int_mm(a, b)
