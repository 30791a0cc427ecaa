"""Matrix products with an f32 result from low-precision operands.

The JAX package asks XLA for `preferred_element_type=jnp.float32` in the LM
head and in every vocab chunk of the losses (llavamod_tpu/ops/losses.py
`_chunk_logits`, models/llm/decoder.py `logits_from_hidden`): bf16 operands,
f32 accumulation, and the f32 accumulator returned as it is.  A plain
`torch.mm` of bf16 tensors rounds its result to bf16, so the port takes the
f32 result here instead.
"""

from __future__ import annotations

import torch


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b[N, K].T -> [M, N] f32, accumulated in f32.

    On the card, bf16/f16 operands go to cuBLAS through the f32-output form
    of `torch.mm` (`out_dtype=torch.float32`); elsewhere, and for f32
    operands, the operands are upcast to f32 first (exact products, f32
    sums).  Neither form rounds the result to the operands' dtype."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    return a.float() @ b.float().t()
