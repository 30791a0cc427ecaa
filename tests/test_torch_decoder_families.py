"""The port's decoder against the JAX package across the config flags of
the other model families (the branches the Qwen slice does not take):
Gemma-2 (softcaps, post-sublayer norms, sliding window, norm offset, embed
scale), Phi (LayerNorm, parallel block, partial rotary, MLP/o biases, tied
head bias), MPT (ALiBi without RoPE, plain GELU MLP), MiniCPM (mup residual
and logit scales) and Qwen-1.0 (dynamic NTK, logn attention), plus the
prefix-LM mask.  Fresh prefill, then 2 cached decode steps through the
plain branches; f32, tolerance 1e-4 on non-pad rows."""

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

FAMILIES = {
    "gemma2": dict(head_dim=32, norm_offset=1.0, activation="gelu_tanh",
                   attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=32.0, post_attn_norm=True,
                   post_mlp_norm=True, tie_word_embeddings=True,
                   embed_scale=8.0, sliding_window=4,
                   sliding_window_pattern=2, num_layers=2),
    "phi": dict(norm="layernorm", activation="gelu_tanh", gated_mlp=False,
                o_bias=True, mlp_bias=True, parallel_block=True,
                partial_rotary_factor=0.5, lm_head_bias=True),
    "mpt": dict(norm="layernorm", activation="gelu", gated_mlp=False,
                use_rope=False, alibi=True, qkv_bias=False,
                tie_word_embeddings=True),
    "minicpm": dict(residual_scale=0.3, logit_scale=0.25, embed_scale=2.0),
    "qwen_v1": dict(use_dynamic_ntk=True, use_logn_attn=True,
                    rope_seq_length=8),
}


def _matched(cfg, seed):
    params = jdecoder.init(to_jax_llm(cfg), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def jitter(x):  # non-trivial norms and biases
        return jnp.asarray(np.asarray(x) + 0.1 * rng.randn(*x.shape)
                           .astype(np.float32))

    params = jax.tree_util.tree_map(jitter, params)
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(params))
    return params, model


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_prefill_and_cached_decode(family, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg = tiny_config(**FAMILIES[family])
    jcfg = to_jax_llm(cfg)
    params, model = _matched(cfg, 11)
    b, t, steps = 2, 10, 2
    rng = np.random.RandomState(3)
    ids = rng.randint(1, cfg.vocab_size, (b, t + steps)).astype(np.int32)
    seg = np.ones((b, t), np.int32)
    seg[0, :4] = 0
    pos = np.maximum(np.cumsum(seg, 1) - 1, 0).astype(np.int32)
    jo = _jforward(params, jcfg, input_ids=jnp.asarray(ids[:, :t]),
                   positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                   cache=jdecoder.init_cache(jcfg, b, t + steps,
                                             dtype=jnp.float32),
                   attn_impl="fresh")
    with torch.inference_mode():
        to = tdecoder.forward(model, cfg, input_ids=torch.tensor(ids[:, :t]),
                              positions=torch.tensor(pos),
                              segment_ids=torch.tensor(seg),
                              cache=tdecoder.init_cache(cfg, b, t + steps,
                                                        dtype=torch.float32),
                              attn_impl="fresh")
    real = seg.astype(bool)
    np.testing.assert_allclose(np32(to.hidden)[real], np32(jo.hidden)[real],
                               rtol=TOL, atol=TOL)
    jc, tc = jo.cache, to.cache
    for i in range(steps):
        p = (seg.sum(1) + i)[:, None].astype(np.int32)
        one = np.ones((b, 1), np.int32)
        x = ids[:, t + i:t + i + 1]
        jo = _jforward(params, jcfg, input_ids=jnp.asarray(x),
                       positions=jnp.asarray(p), segment_ids=jnp.asarray(one),
                       cache=jc)
        with torch.inference_mode():
            to = tdecoder.forward(model, cfg, input_ids=torch.tensor(x),
                                  positions=torch.tensor(p),
                                  segment_ids=torch.tensor(one), cache=tc)
        jc, tc = jo.cache, to.cache
        np.testing.assert_allclose(np32(to.hidden), np32(jo.hidden),
                                   rtol=TOL, atol=TOL)
    with torch.inference_mode():
        tl = tdecoder.logits_from_hidden(model, cfg, to.hidden)
    np.testing.assert_allclose(
        np32(tl), np32(jdecoder.logits_from_hidden(params, jcfg, jo.hidden)),
        rtol=TOL, atol=TOL)


def test_prefix_lm_mask_without_cache():
    cfg = tiny_config()
    jcfg = to_jax_llm(cfg)
    params, model = _matched(cfg, 12)
    b, t = 2, 9
    rng = np.random.RandomState(4)
    ids = rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32)
    seg = np.ones((b, t), np.int32)
    seg[1, :3] = 0
    prefix = np.zeros((b, t), bool)
    prefix[:, 3:6] = True
    jo = jdecoder.forward(params, jcfg, input_ids=jnp.asarray(ids),
                          segment_ids=jnp.asarray(seg),
                          prefix_mask=jnp.asarray(prefix))
    with torch.inference_mode():
        to = tdecoder.forward(model, cfg, input_ids=torch.tensor(ids),
                              segment_ids=torch.tensor(seg),
                              prefix_mask=torch.tensor(prefix))
    real = seg.astype(bool)
    np.testing.assert_allclose(np32(to.hidden)[real], np32(jo.hidden)[real],
                               rtol=TOL, atol=TOL)
