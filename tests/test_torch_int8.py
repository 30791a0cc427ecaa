"""The port's int8 W8A8 path (llavamod_tpu_torch/ops/int8.py, the int8
parts of models/llm/decoder.py, models/params.py `Int8Weight`, the int8
heads of ops/losses.py, models/builder.py `quantize_for_serving`) against
the JAX package's, on the same seeded numpy inputs and weights, f32:

  * the quantizers' int8 values equal JAX's, except that a value on a
    rounding tie may differ by 1 in at most 0.1% of the entries (never by
    more); their scales agree to rtol 1e-6;
  * `dense_int8` and `expert_dense_int8`, forward and straight-through dx,
    against JAX's custom_vjp at rtol 1e-5 (the same int8 weights on both
    sides);
  * `quantize_decoder_int8`'s state_dict keys are the JAX tree paths for
    fuse on/off and each include_* flag, and a second call changes nothing;
  * a quantized tiny decoder's logits (rtol 1e-4) and a greedy `generate`
    after `quantize_for_serving` (the same ids) match JAX;
  * `Int8Weight.scale` stays f32 through `.to(torch.bfloat16)`.

The losses with int8 heads are in tests/test_torch_int8_losses.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from util_torch_port import (
    flatten_numpy,
    jax_batch,
    matched_llava,
    multimodal_arrays,
    tiny_llava_config,
    to_jax_llm,
    torch_batch,
)

from llavamod_tpu import generation as jgen
from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models.llm import decoder as jdec
from llavamod_tpu_torch import generation as tgen
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    state_dict_from_numpy,
)
from llavamod_tpu_torch.models import builder as tbuilder
from llavamod_tpu_torch.models.llm import decoder as tdec
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.params import Int8Weight
from llavamod_tpu_torch.ops.int8 import act_quant_rows, int8_matmul

torch.set_num_threads(2)


def _int8_equal_but_ties(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def _w(jw) -> Int8Weight:
    """The port's form of a JAX int8 dict, the same arrays."""
    jw = jax.device_get(jw)
    return Int8Weight(torch.tensor(np.asarray(jw["w_int8"])),
                      torch.tensor(np.asarray(jw["scale"])))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_act_quant_rows_and_int8_matmul():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 40) * rng.rand(6, 5, 1) * 3).astype(np.float32)
    x[0, 0] = 0.0                               # an all-zero row: scale 1e-8
    q, s = act_quant_rows(torch.tensor(x))
    jq, js = jdec._act_quant_rows(jnp.asarray(x))
    _int8_equal_but_ties(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) == 127 and (q[0, 0] == 0).all()
    a = torch.randint(-127, 128, (9, 24), dtype=torch.int8)
    b = torch.randint(-127, 128, (16, 24), dtype=torch.int8)
    y = int8_matmul(a, b.t())                   # a transposed view of B
    assert y.dtype == torch.int32
    assert torch.equal(y.double(), a.double() @ b.double().t())
    with pytest.raises(TypeError):
        int8_matmul(a.float(), b.t())


@pytest.mark.parametrize("kind", ["dense", "head", "experts"])
def test_quantizers_match_jax(kind):
    rng = np.random.RandomState(1)
    if kind == "experts":
        w = rng.randn(3, 32, 48).astype(np.float32)
        jq = jdec.quantize_experts_int8({"up": jnp.asarray(w)})["up"]
        group = tdec.ParamGroup(up=torch.tensor(w))
        tq = tdec.quantize_experts_int8(group).up
    else:
        w = rng.randn(40, 56).astype(np.float32)
        jfn = {"dense": jdec.quantize_dense_int8,
               "head": jdec.quantize_head_int8}[kind]
        tfn = {"dense": tdec.quantize_dense_int8,
               "head": tdec.quantize_head_int8}[kind]
        jq, tq = jfn(jnp.asarray(w)), tfn(torch.tensor(w))
    assert tq.w_int8.shape == jq["w_int8"].shape
    _int8_equal_but_ties(tq.w_int8.numpy(), np.asarray(jq["w_int8"]))
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq["scale"]),
                               rtol=1e-6)
    assert tq.scale.dtype == torch.float32
    if kind != "head":
        # stored K-major for the card's int8 GEMM, shown in the JAX layout
        assert tq.w_int8.stride()[-2] == 1


@jax.jit
def _jax_vjp_dense(x, w_int8, scale, g):
    y, vjp = jax.vjp(lambda x_: jdec.dense_int8(x_, w_int8, scale), x)
    return y, vjp(g)[0]


@jax.jit
def _jax_vjp_experts(x, w_int8, scale, g):
    y, vjp = jax.vjp(lambda x_: jdec.expert_dense_int8(x_, w_int8, scale), x)
    return y, vjp(g)[0]


@pytest.mark.parametrize("kind", ["dense", "experts"])
def test_int8_products_and_their_straight_through_backward(kind):
    rng = np.random.RandomState(2)
    if kind == "dense":
        x = rng.randn(3, 7, 32).astype(np.float32)
        jw = jdec.quantize_dense_int8(jnp.asarray(rng.randn(32, 24)
                                                  .astype(np.float32)))
        jfn, tfn = _jax_vjp_dense, tdec.dense_int8
        g = rng.randn(3, 7, 24).astype(np.float32)
    else:
        x = rng.randn(4, 6, 32).astype(np.float32)
        jw = jdec.quantize_experts_int8(
            {"up": jnp.asarray(rng.randn(4, 32, 24).astype(np.float32))})["up"]
        jfn, tfn = _jax_vjp_experts, tdec.expert_dense_int8
        g = rng.randn(4, 6, 24).astype(np.float32)
    want_y, want_dx = (np.asarray(a) for a in jfn(
        jnp.asarray(x), jw["w_int8"], jw["scale"], jnp.asarray(g)))
    w = _w(jw)
    tx = torch.tensor(x, requires_grad=True)
    y = tfn(tx, w.w_int8, w.scale)
    y.backward(torch.tensor(g))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, rtol=1e-5,
                               atol=1e-6)


def test_int8_weight_keeps_f32_scales_through_a_cast():
    w = tdec.quantize_dense_int8(torch.randn(16, 8))
    e = Int8Weight(w.w_int8, w.scale, torch.zeros((0,)))
    e.to(torch.bfloat16)
    assert e.scale.dtype == torch.float32 and e.w_int8.dtype == torch.int8
    assert e.dtype_ref.dtype == torch.bfloat16     # the activation dtype
    assert torch.equal(e.scale, w.scale)
    assert list(dict(e.named_buffers())) == ["w_int8", "scale", "dtype_ref"]
    assert not list(e.parameters())


# ---------------------------------------------------------------------------
# the quantized decoder
# ---------------------------------------------------------------------------

FLAGS = {
    "default": {},
    "unfused": dict(fuse=False),
    "lm_head": dict(include_lm_head=True),
    "experts": dict(include_experts=True),
    "embed": dict(include_embed=True),
    "attention-only": dict(include_mlp=False),
    "serving": dict(include_lm_head=True, include_experts=True,
                    include_embed=True),
}


def _decoder_pair(tied=False, residual=False, seed=3):
    cfg = tiny_config(moe_num_experts=4, moe_layers=(0,),
                      tie_word_embeddings=tied, moe_use_residual=residual)
    params = jax.jit(jdec.init, static_argnums=0)(to_jax_llm(cfg),
                                                  jax.random.PRNGKey(seed))
    model = tdec.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(params))
    return cfg, params, model


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_quantize_decoder_keys_values_and_idempotence(flags, tied):
    cfg, params, model = _decoder_pair(tied, residual=flags == "experts")
    want = state_dict_from_numpy(jax.device_get(
        jdec.quantize_decoder_int8(params, **FLAGS[flags])))
    tdec.quantize_decoder_int8(model, **FLAGS[flags])
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == torch.int8:
            _int8_equal_but_ties(got[k].numpy(), w.numpy())
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_allclose(got[k].float().numpy(),
                                       w.float().numpy(), rtol=1e-6, err_msg=k)
    again = {k: v.clone() for k, v in got.items()}
    tdec.quantize_decoder_int8(model, **FLAGS[flags])
    after = model.state_dict()
    assert set(after) == set(again)
    assert all(torch.equal(after[k], v) for k, v in again.items())
    # the float weights that were quantized are gone from the parameters
    assert all(not isinstance(m, Int8Weight) or not list(m.parameters())
               for m in model.modules())


def test_quantized_jax_tree_loads_leaf_for_leaf_and_logits_match():
    cfg, params, model = _decoder_pair(residual=True)
    jq = jdec.quantize_decoder_int8(params, **FLAGS["serving"])
    tdec.quantize_decoder_int8(model, **FLAGS["serving"])
    load_jax_params(model, jax.device_get(jq))   # strict, leaf for leaf
    assert model.embed.embedding.scale.dtype == torch.float32
    ids = np.random.RandomState(4).randint(1, cfg.vocab_size, (2, 9))
    jcfg = to_jax_llm(cfg)
    jout = jdec.forward(jq, jcfg, input_ids=jnp.asarray(ids))
    want = np.asarray(jdec.logits_from_hidden(jq, jcfg, jout.hidden))
    with torch.no_grad():
        out = tdec.forward(model, cfg, input_ids=torch.tensor(ids))
        got = tdec.logits_from_hidden(model, cfg, out.hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_greedy_generate_after_quantize_for_serving_matches_jax(monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg = tiny_llava_config()
    jcfg, params, model = matched_llava(cfg, seed=7)
    arrays = multimodal_arrays(cfg, [16, 11, 5], 20, seed=8,
                               with_image=[True, False, True])
    jparams = jbuilder.quantize_for_serving(params, jcfg)
    tbuilder.quantize_for_serving(model)
    assert isinstance(model.llm.embed.embedding, Int8Weight)
    assert isinstance(model.llm.layers[0].mlp.experts.up, Int8Weight)
    load_jax_params(model, jax.device_get(jparams))
    want = jgen.generate(jparams, jcfg, jax_batch(arrays),
                         jgen.GenerationConfig(max_new_tokens=6,
                                               cache_dtype="float32"),
                         rng=jax.random.PRNGKey(0))
    got = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
        max_new_tokens=6, cache_dtype="float32"))
    assert (got == want).all(), (got, want)
    want_sd = flatten_numpy(jax.device_get(jparams))
    assert set(model.state_dict()) == set(want_sd)
