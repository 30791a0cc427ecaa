"""llavamod_tpu_torch: the PyTorch/CUDA port of llavamod_tpu.

The serving path of the JAX package (batching HTTP server -> batched cached
generation -> LLaVA forward) in PyTorch, with the two Pallas kernels on that
path rewritten by hand in CUDA C++ for Hopper (csrc/):

  * flash_fwd    (ops/flash_attention.py) — prefill attention,
  * flash_decode (ops/decode_attention.py) — single-token cached attention.

Module structure and names follow llavamod_tpu; module state_dict keys are
the JAX param-tree paths joined by '.', with the JAX weight layouts
([D_in, D_out] used as x @ w, stacked experts [E, D, F], a [V, D] head), so
a JAX tree converts leaf for leaf (interop/from_jax.py).  The package imports
torch and never jax; only jax-free host modules of llavamod_tpu
(conversation, constants, mm_utils, data.splice, utils.registry) are reused.
"""

__version__ = "0.1.0"
