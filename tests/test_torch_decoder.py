"""The port's decoder against the JAX package with the same weights: a
fresh prefill (attn_impl="fresh") into a KV cache, then 3 single-token
decode steps, for a dense and an MoE layer stack.  f32, tolerance 1e-4 on
non-pad rows.  The JAX side decodes through its XLA branch
(LLAVAMOD_DECODE_ATTN=xla); K2's plain version is held to the Pallas kernel
in tests/test_torch_decode_attention.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from util_torch_port import np32, to_jax_llm

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.llm.config import tiny_config

TOL = 1e-4
_jforward = jax.jit(jdecoder.forward, static_argnums=(1,),
                    static_argnames=("attn_impl",))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_decoder_prefill_then_cached_decode(moe, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg = tiny_config(moe_num_experts=4 if moe else 0,
                      moe_layers=(1,) if moe else ())
    jcfg = to_jax_llm(cfg)
    params = jdecoder.init(jcfg, jax.random.PRNGKey(0))
    if moe:
        rng = np.random.RandomState(1)
        params["layers"][1]["mlp"]["router"] = jnp.asarray(
            rng.randn(64, 4).astype(np.float32))
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(params))

    b, t, steps = 2, 12, 3
    rng = np.random.RandomState(2)
    ids = rng.randint(1, cfg.vocab_size, (b, t + steps)).astype(np.int32)
    seg = np.ones((b, t), np.int32)
    seg[1, :5] = 0                                   # left padding
    pos = np.maximum(np.cumsum(seg, 1) - 1, 0).astype(np.int32)
    jc = jdecoder.init_cache(jcfg, b, t + steps, dtype=jnp.float32)
    tc = tdecoder.init_cache(cfg, b, t + steps, dtype=torch.float32)
    jo = _jforward(params, jcfg, input_ids=jnp.asarray(ids[:, :t]),
                          positions=jnp.asarray(pos),
                          segment_ids=jnp.asarray(seg), cache=jc,
                          attn_impl="fresh")
    with torch.inference_mode():
        to = tdecoder.forward(model, cfg, input_ids=torch.tensor(ids[:, :t]),
                              positions=torch.tensor(pos),
                              segment_ids=torch.tensor(seg), cache=tc,
                              attn_impl="fresh")
    real = seg.astype(bool)
    np.testing.assert_allclose(np32(to.hidden)[real], np32(jo.hidden)[real],
                               rtol=TOL, atol=TOL)
    assert len(to.router_probs) == len(jo.router_probs) == int(moe)
    np.testing.assert_allclose(np32(to.cache.k), np32(jo.cache.k), rtol=TOL,
                               atol=TOL)
    assert to.cache.length == int(jo.cache.length) == t
    jc, tc = jo.cache, to.cache
    prompt_len = seg.sum(1)
    for i in range(steps):
        step_ids = ids[:, t + i:t + i + 1]
        p = (prompt_len + i)[:, None].astype(np.int32)
        one = np.ones((b, 1), np.int32)
        jo = _jforward(params, jcfg, input_ids=jnp.asarray(step_ids),
                              positions=jnp.asarray(p),
                              segment_ids=jnp.asarray(one), cache=jc)
        with torch.inference_mode():
            to = tdecoder.forward(model, cfg, input_ids=torch.tensor(step_ids),
                                  positions=torch.tensor(p),
                                  segment_ids=torch.tensor(one), cache=tc)
        np.testing.assert_allclose(np32(to.hidden), np32(jo.hidden),
                                   rtol=TOL, atol=TOL)
        jc, tc = jo.cache, to.cache
    assert (tc.segment.numpy() == np.asarray(jc.segment)).all()
    jl = jdecoder.logits_from_hidden(params, jcfg, jo.hidden)
    with torch.inference_mode():
        tl = tdecoder.logits_from_hidden(model, cfg, to.hidden)
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=TOL, atol=TOL)


def test_bf16_logits_keep_the_f32_accumulator():
    """bf16 hidden states and head: the logits are the f32 accumulator, as
    the JAX head's preferred_element_type=f32 einsum, not a bf16-rounded
    product (which misses by up to half a bf16 ulp, ~0.06 here)."""
    cfg = tiny_config(vocab_size=300)
    rng = np.random.RandomState(4)
    w = jnp.asarray(rng.randn(cfg.vocab_size, cfg.hidden_size) * 0.5,
                    jnp.bfloat16)
    h = jnp.asarray(rng.randn(2, 5, cfg.hidden_size) * 4.0, jnp.bfloat16)
    want = np.asarray(jdecoder.logits_from_hidden(
        {"embed": {"embedding": w}, "lm_head": {"weight": w}},
        to_jax_llm(cfg), h), np.float32)
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16)
    with torch.no_grad():
        model.lm_head.weight.copy_(torch.tensor(np.asarray(w, np.float32)))
    th = torch.tensor(np.asarray(h, np.float32)).bfloat16()
    with torch.inference_mode():
        got = tdecoder.logits_from_hidden(model, cfg, th)
        rounded = (th @ model.lm_head.weight.t()).float().numpy()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    assert np.abs(rounded - want).max() > 1e-2   # the old rounding fails
