"""The port's HF interop (llavamod_tpu_torch/interop/{hf,safetensors_io}.py,
models/builder.py `import_hf_llava`, `load_pretrained_model`) against the
JAX package's, on tiny models that transformers builds (and the golden
torch oracles for qwen-1.0 and MiniCPM, which transformers does not ship):

  * configs, per family: the port reads config.json with `json` and its
    table of config-class defaults; it must give JAX's DecoderConfig from
    `AutoConfig`, field for field, for the `save_pretrained` config and for
    one trimmed of the keys whose class default differs from the JAX
    fallback (tie_word_embeddings, sliding_window, partial_rotary_factor);
  * parameters, per family, from f32 and bf16 checkpoint files: bitwise
    JAX's after an f32 upcast; logits at the JAX tests' 2e-3 against
    transformers and 1e-4 against JAX's decoder (attn_impl 'xla');
    to_hf -> from_hf round-trips bitwise;
  * CLIP and SigLIP towers bitwise JAX's; a CLIP checkpoint without the
    patch bias the registered CLIP config declares loads (JAX's converter
    raises); linear / mlp2x_gelu / pool_mlp2x_gelu and the Q-Former
    projectors round-trip and equal JAX's; the simple types have no HF
    layout in either package, and their mm_projector.bin interchanges;
  * export both ways, dense and MoE: the port's `export_hf_llava` read by
    JAX's `import_hf_llava`, and JAX's export read by the port, bitwise;
  * the safetensors reader against `safetensors.safe_open(framework='pt')`
    for every dtype, sharded with an index; malformed files raise; the
    reader and the HF modules load where safetensors, transformers and
    ml_dtypes cannot be imported;
  * `load_pretrained_model` on an HF LLaVA directory: a ValueError naming
    vision_path without a tower, the model with one."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import transformers
from golden.hf_family_refs import TinyMiniCPM, TinyQwenV1
from safetensors import safe_open
from safetensors.torch import save_file
from util_torch_port import tiny_llava_config, to_jax_llava, to_jax_llm

import jax
import jax.numpy as jnp

from llavamod_tpu.interop import hf as jhf
from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.models.projector import build_projector as jbuild_projector
from llavamod_tpu.models.vision import vit as jvit
from llavamod_tpu.models.vision.vit import VisionConfig as JVisionConfig
from llavamod_tpu.train import checkpoint as jckpt
from llavamod_tpu_torch.interop import hf
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.interop.safetensors_io import read_safetensors
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.projector import build_projector
from llavamod_tpu_torch.models.vision import vit as tvit
from llavamod_tpu_torch.models.vision.vit import VisionConfig
from llavamod_tpu_torch.train import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF_TOL = 2e-3      # the JAX HF tests' tolerance against transformers
JAX_TOL = 1e-4     # port vs JAX decoder, f32


@pytest.fixture(scope="module", autouse=True)
def _tiny_tower_name():
    """HF LLaVA exports name their tower (`mm_image_tower`): register the
    tiny one in both packages, as tests/test_import_hf_tool.py does."""
    for registry, cfg in ((tvit.vision_configs, tvit.tiny_vision_config()),
                          (jvit.vision_configs, jvit.tiny_vision_config())):
        if "tiny-vit" not in registry:
            registry.register("tiny-vit", cfg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def assert_bitwise(port_state, jax_tree):
    want = _flat(jax_tree)
    got = {k: v.float().numpy() for k, v in port_state.items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# tiny families
# ---------------------------------------------------------------------------

def _qwen2():
    return transformers.Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False)


def _llama():
    return transformers.LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=80,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attention_bias=False)


def _mistral():
    return transformers.MistralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, sliding_window=None,
        tie_word_embeddings=False)


def _gemma2():
    return transformers.Gemma2Config(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, query_pre_attn_scalar=16,
        sliding_window=8, tie_word_embeddings=True,
        attn_implementation="eager")


def _phi():
    return transformers.PhiConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        qk_layernorm=False, hidden_act="gelu_new",
        attn_implementation="eager")


def _stablelm():
    return transformers.StableLmConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, partial_rotary_factor=0.25,
        use_qkv_bias=False, use_parallel_residual=False, qk_layernorm=False,
        attn_implementation="eager")


def _mpt():
    # transformers' MptMLP is 4 x d_model whatever expansion_ratio says (the
    # reference's vendored MPT honours it): keep the two equal
    return transformers.MptConfig(
        d_model=32, n_heads=4, n_layers=2, expansion_ratio=4,
        max_seq_len=64, vocab_size=96,
        attn_config=transformers.models.mpt.configuration_mpt
        .MptAttentionConfig(alibi=True, alibi_bias_max=8),
        attn_implementation="eager")


HF_FAMILIES = {"qwen2": _qwen2, "llama": _llama, "mistral": _mistral,
               "gemma2": _gemma2, "phi": _phi, "stablelm": _stablelm,
               "mpt": _mpt}
HF_CLASSES = {"qwen2": transformers.Qwen2ForCausalLM,
              "llama": transformers.LlamaForCausalLM,
              "mistral": transformers.MistralForCausalLM,
              "gemma2": transformers.Gemma2ForCausalLM,
              "phi": transformers.PhiForCausalLM,
              "stablelm": transformers.StableLmForCausalLM,
              "mpt": transformers.MptForCausalLM}

# config.json of the families with remote-code modelings only (the keys the
# JAX tests' stand-in config classes carry)
QWEN_V1_JSON = dict(model_type="qwen", vocab_size=96, hidden_size=32,
                    intermediate_size=96, num_hidden_layers=2,
                    num_attention_heads=4, seq_length=64,
                    rotary_emb_base=10000.0, layer_norm_epsilon=1e-6,
                    use_dynamic_ntk=True, use_logn_attn=True, no_bias=True)
MINICPM_JSON = dict(model_type="minicpm", vocab_size=96, hidden_size=32,
                    intermediate_size=64, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=4,
                    max_position_embeddings=64, rope_theta=10000.0,
                    rms_norm_eps=1e-5, tie_word_embeddings=True, scale_emb=12.0,
                    scale_depth=1.4, dim_model_base=8)
TRAP_KEYS = ("tie_word_embeddings", "sliding_window", "partial_rotary_factor")


def _write_config(path, hf_cfg, drop=()):
    hf_cfg.save_pretrained(path)
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    for k in drop:
        d.pop(k, None)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)
    return d


@pytest.mark.parametrize("trimmed", [False, True], ids=["saved", "trimmed"])
@pytest.mark.parametrize("family", sorted(HF_FAMILIES))
def test_config_equals_jax_through_autoconfig(tmp_path, family, trimmed):
    d = _write_config(str(tmp_path), HF_FAMILIES[family](),
                      TRAP_KEYS if trimmed else ())
    want = jhf.decoder_config_from_hf(
        transformers.AutoConfig.from_pretrained(str(tmp_path)))
    got = hf.decoder_config_from_hf(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == hf.decoder_config_from_hf(hf.load_hf_config(str(tmp_path)))


def test_trimmed_configs_take_the_class_defaults(tmp_path):
    """The three defaults of the JAX fallbacks that AutoConfig overrides:
    the port takes the class's value, as the JAX package does."""
    got = {}
    for family in ("gemma2", "mistral", "stablelm"):
        d = _write_config(str(tmp_path / family), HF_FAMILIES[family](),
                          TRAP_KEYS)
        got[family] = hf.decoder_config_from_hf(d)
    assert got["gemma2"].tie_word_embeddings is True
    assert got["gemma2"].sliding_window == 4096
    assert got["mistral"].sliding_window == 4096
    assert got["stablelm"].partial_rotary_factor == 0.25


@pytest.mark.parametrize("d", [QWEN_V1_JSON, MINICPM_JSON, dict(
    _qwen2().to_dict(), model_type="moe_llava_qwen1_5",
    moe=dict(moe_enable=True, moe_layers_idx=[0], num_experts=[4],
             top_k_experts=2, capacity_factor=1.5, eval_capacity_factor=2.0,
             min_capacity=4, use_residual=False, router_aux_loss_coef=0.01))],
    ids=["qwen", "minicpm", "moe_llava_qwen1_5"])
def test_remote_code_configs_equal_jax(d):
    """transformers has no class for these: JAX's function reads the same
    dict as a namespace."""
    want = jhf.decoder_config_from_hf(types.SimpleNamespace(**d))
    got = hf.decoder_config_from_hf(json.loads(json.dumps(d)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if "moe" in d:
        assert got.is_moe and got.moe_layers == (0,)


def test_unsupported_model_type_and_layout_raise():
    with pytest.raises(ValueError, match="gptj"):
        hf.decoder_config_from_hf(dict(_llama().to_dict(), model_type="gptj"))
    with pytest.raises(ValueError, match="Unrecognized"):
        hf.decoder_params_from_hf({"h.0.attn.qkv.weight": torch.zeros(3, 3)},
                                  hf.decoder_config_from_hf(_llama().to_dict()))


# ---------------------------------------------------------------------------
# parameters and logits, per family
# ---------------------------------------------------------------------------

def _oracle(family, seed):
    """(config.json dict, torch model with HF state-dict keys, logits fn)."""
    torch.manual_seed(seed)
    if family == "qwen":
        m = TinyQwenV1(dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                            num_layers=2, num_heads=4, rope_theta=10000.0,
                            rms_norm_eps=1e-6)).eval()
        return dict(QWEN_V1_JSON), m, lambda ids: m(ids)
    if family == "minicpm":
        m = TinyMiniCPM(dict(vocab_size=96, hidden_size=32,
                             intermediate_size=64, num_layers=4, num_heads=4,
                             rope_theta=10000.0, rms_norm_eps=1e-5,
                             scale_emb=12.0, scale_depth=1.4,
                             dim_model_base=8)).eval()
        return dict(MINICPM_JSON), m, lambda ids: m(ids)
    hf_cfg = HF_FAMILIES[family]()
    m = HF_CLASSES[family](hf_cfg).eval()
    with torch.no_grad():   # non-trivial norms and biases
        for name, p in m.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    return hf_cfg.to_dict(), m, lambda ids: m(ids).logits


def _write_checkpoint(path, d, model, dtype):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)
    state = {k: v.detach().to(dtype).contiguous()
             for k, v in model.state_dict().items()}
    state = {k: v.clone() for k, v in state.items()}  # untie shared storage
    save_file(state, os.path.join(path, "model.safetensors"))
    return state


def _jax_logits(params, cfg, ids):
    out = jdecoder.forward(params, cfg, input_ids=jnp.asarray(ids),
                           attn_impl="xla")
    return np.asarray(jdecoder.logits_from_hidden(params, cfg, out.hidden))


@pytest.mark.parametrize("family", sorted(HF_FAMILIES) + ["minicpm", "qwen"])
def test_family_params_and_logits_equal_jax(tmp_path, family, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    d, oracle, logits_fn = _oracle(family, seed=3)
    ids = np.random.RandomState(3).randint(0, 96, size=(2, 12))
    with torch.no_grad():
        want_hf = logits_fn(torch.tensor(ids)).float().numpy()
    for dtype in (torch.float32, torch.bfloat16):
        path = str(tmp_path / str(dtype))
        written = _write_checkpoint(path, d, oracle, dtype)
        cfg = hf.decoder_config_from_hf(hf.load_hf_config(path))
        state = builder._load_torch_state(path)
        assert all(v.dtype == dtype for v in state.values())
        got = hf.decoder_params_from_hf(state, cfg)
        assert all(v.dtype == dtype for v in got.values())
        jparams = jhf.decoder_params_from_hf(written, to_jax_llm(cfg))
        assert_bitwise(got, jparams)
        # to_hf -> from_hf round-trips bitwise (the file's keys and values)
        back = hf.decoder_params_to_hf(got, cfg)
        assert back.keys() <= written.keys()
        for k, v in back.items():
            assert torch.equal(v, written[k]), k
        if dtype == torch.bfloat16:
            continue
        model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
        keys = model.load_state_dict(got, strict=False)
        assert not keys.unexpected_keys
        for k in keys.missing_keys:      # MPT's weight-only LayerNorms
            assert k.endswith("norm.bias"), k
            delattr(model.get_submodule(k.rsplit(".", 1)[0]), "bias")
        with torch.no_grad():
            out = tdecoder.forward(model, cfg, input_ids=torch.tensor(ids),
                                   attn_impl="xla")
            port = tdecoder.logits_from_hidden(model, cfg, out.hidden).numpy()
        np.testing.assert_allclose(port, want_hf, rtol=HF_TOL, atol=HF_TOL)
        np.testing.assert_allclose(
            port, _jax_logits(jparams, to_jax_llm(cfg), ids), rtol=JAX_TOL,
            atol=JAX_TOL)


# ---------------------------------------------------------------------------
# vision towers and projectors
# ---------------------------------------------------------------------------

CLIP = dict(name="tiny-clip", image_size=28, patch_size=14, hidden_size=32,
            intermediate_size=64, num_layers=2, num_heads=4, patch_bias=False)
SIGLIP = dict(CLIP, name="tiny-siglip", use_class_token=False,
              use_pre_layernorm=False, activation="gelu_tanh",
              layer_norm_eps=1e-6, patch_bias=True)


def _hf_tower(kind, seed):
    torch.manual_seed(seed)
    if kind == "clip":
        return transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14,
            hidden_act="quick_gelu", layer_norm_eps=1e-5)).eval()
    return transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=14,
        hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6,
        attn_implementation="eager")).eval()


@pytest.mark.parametrize("kind", ["clip", "siglip"])
def test_vision_params_equal_jax_and_match_hf(kind):
    hf_model = _hf_tower(kind, seed=10)
    kw = CLIP if kind == "clip" else SIGLIP
    cfg = VisionConfig(**kw)
    state = {k: v.bfloat16() for k, v in hf_model.state_dict().items()}
    got = hf.vision_params_from_hf(state, cfg)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert_bitwise(got, jhf.vision_params_from_hf(state, JVisionConfig(**kw)))
    tower = tvit.init(cfg, torch.Generator().manual_seed(0))
    tower.load_state_dict(hf.vision_params_from_hf(hf_model.state_dict(), cfg),
                          strict=True)
    px = np.random.RandomState(10).randn(2, 3, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = hf_model(torch.tensor(px), output_hidden_states=True
                        ).hidden_states[-2].numpy()
        got_h = tvit.forward(tower, cfg, torch.tensor(px), -2).numpy()
    np.testing.assert_allclose(got_h, want, rtol=HF_TOL, atol=HF_TOL)


def test_clip_without_patch_bias_loads_under_the_registered_flag():
    """The registered CLIP-ViT-L/336 config declares a patch bias that HF
    CLIP's convolution lacks: the JAX converter raises, the port reads
    zeros, which computes the same tower."""
    hf_model = _hf_tower("clip", seed=11)
    kw = dict(CLIP, patch_bias=True)
    state = hf_model.state_dict()
    assert "vision_model.embeddings.patch_embedding.bias" not in state
    with pytest.raises(KeyError, match="patch_embedding.bias"):
        jhf.vision_params_from_hf(state, JVisionConfig(**kw))
    got = hf.vision_params_from_hf(state, VisionConfig(**kw))
    assert torch.equal(got["patch_embed.bias"], torch.zeros(32))
    cfg = VisionConfig(**kw)
    tower = tvit.init(cfg, torch.Generator().manual_seed(0))
    tower.load_state_dict(got, strict=True)
    px = np.random.RandomState(11).randn(1, 3, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = hf_model(torch.tensor(px), output_hidden_states=True
                        ).hidden_states[-2].numpy()
        np.testing.assert_allclose(
            tvit.forward(tower, cfg, torch.tensor(px), -2).numpy(), want,
            rtol=HF_TOL, atol=HF_TOL)


@pytest.mark.parametrize("kind", ["linear", "mlp2x_gelu", "pool_mlp2x_gelu"])
def test_projector_roundtrip_equals_jax(kind):
    jproj = jbuild_projector(kind, 16, 24)
    jparams = jax.device_get(jproj.init(jax.random.PRNGKey(0)))
    module = build_projector(kind, 16, 24).init(torch.Generator())
    load_jax_params(module, jparams)
    state = hf.projector_params_to_hf(module.state_dict(), kind)
    want = jhf.projector_params_to_hf(jparams, kind)
    assert state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k], err_msg=k)
    back = hf.projector_params_from_hf(state, kind)
    assert_bitwise(back, jhf.projector_params_from_hf(state, kind))
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k
    # the port's projector computes JAX's (pooling 4x4 -> 2x2 tokens)
    x = np.random.RandomState(1).randn(2, 16, 16).astype(np.float32)
    with torch.no_grad():
        got = build_projector(kind, 16, 24).apply(module, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jproj.apply(jparams, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["qformer2_32", "cheap_qformer2_32",
                                  "simple_in2_out2", "cheap_simple_in2_out2"])
def test_unported_projector_layouts_raise_item_6(kind, tmp_path):
    """Once item 6's refusals, now its layouts: the Q-Former's Blip2 keys
    round-trip and equal JAX's bitwise; the simple projector has no HF
    layout in either package (both raise the same NotImplementedError), and
    its mm_projector.bin tree layout is read by each package from the
    other's file."""
    jproj = jbuild_projector(kind, 16, 24)
    jparams = jax.device_get(jproj.init(jax.random.PRNGKey(0)))
    module = build_projector(kind, 16, 24).init(torch.Generator())
    load_jax_params(module, jparams)
    if "qformer" in kind:
        state = hf.projector_params_to_hf(module.state_dict(), kind)
        want = jhf.projector_params_to_hf(jparams, kind)
        assert state.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(state[k].numpy(), want[k],
                                          err_msg=k)
        back = hf.projector_params_from_hf(state, kind)
        for k, v in module.state_dict().items():
            assert torch.equal(back[k], v), k
        return
    for side in (hf, jhf):
        with pytest.raises(NotImplementedError, match="not implemented"):
            side.projector_params_from_hf({}, kind)
        with pytest.raises(NotImplementedError, match="not implemented"):
            side.projector_params_to_hf(
                module.state_dict() if side is hf else jparams, kind)
    path = tckpt.save_mm_projector(str(tmp_path / "p.bin"),
                                   module.state_dict(), kind)
    back = jckpt.load_mm_projector(path, kind, template=jparams)
    jax.tree_util.tree_map(
        lambda u, v: np.testing.assert_array_equal(np.asarray(u),
                                                   np.asarray(v)),
        back, jparams)


# ---------------------------------------------------------------------------
# export, both ways
# ---------------------------------------------------------------------------

def _tiny_llava(moe: bool):
    cfg = tiny_llava_config(num_heads=4, num_kv_heads=2, qkv_bias=True,
                            tie_word_embeddings=False,
                            **({} if moe else dict(moe_num_experts=0,
                                                   moe_layers=())))
    jcfg = to_jax_llava(cfg)
    params = jax.device_get(jllava.init(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x))
        .astype(np.float32), params)
    model = tllava.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return cfg, jcfg, params, model


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_export_both_ways_equals_jax(tmp_path, moe):
    cfg, jcfg, params, model = _tiny_llava(moe)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    hf.export_hf_llava(ours, cfg, model.state_dict())
    jhf.export_hf_llava(theirs, jcfg, params)
    with open(os.path.join(ours, "config.json")) as f:
        a = json.load(f)
    with open(os.path.join(theirs, "config.json")) as f:
        assert a == json.load(f)
    sa = torch.load(os.path.join(ours, "pytorch_model.bin"), weights_only=True)
    sb = torch.load(os.path.join(theirs, "pytorch_model.bin"),
                    weights_only=True)
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    if moe:
        # the DeepSpeed-MoE names (tests/test_hf_export.py:76)
        assert "model.layers.0.mlp.deepspeed_moe.gate.wg.weight" in sa
        assert ("model.layers.0.mlp.deepspeed_moe.experts.deepspeed_experts"
                ".1.up_proj.weight") in sa
        assert "model.layers.1.mlp.up_proj.weight" in sa
    assert "model.mm_projector.image_spatial_proj.0.weight" in sa
    # port export -> JAX import, JAX export -> port import
    jcfg2, jparams2 = jbuilder.import_hf_llava(ours)
    cfg2, model2 = builder.import_hf_llava(theirs, device="cpu")
    assert dataclasses.asdict(jcfg2.llm) == dataclasses.asdict(cfg2.llm)
    assert cfg2.llm.is_moe == moe and not hasattr(model2, "vision")
    for group in ("llm", "projector"):
        assert_bitwise(hf.pick(model2.state_dict(), group), jparams2[group])
        assert_bitwise(hf.pick(model.state_dict(), group), params[group])


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
          torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool]


def test_reader_equals_safe_open_for_every_dtype(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3, 5 + i, generator=g) * 50
        state[f"t.{dt}".replace("torch.", "")] = (
            x > 0 if dt == torch.bool else x.to(dt))
    state["odd"] = torch.ones(3, dtype=torch.bool)     # unaligned after it
    state["after_odd"] = torch.arange(5, dtype=torch.float32)
    state["empty"] = torch.zeros(0, 4)
    state["scalar"] = torch.tensor(2.5)
    path = str(tmp_path / "all.safetensors")
    save_file(state, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert got.keys() == want.keys() == state.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_sharded_index_directory_equals_safe_open(tmp_path):
    torch.manual_seed(0)
    m = transformers.Qwen2ForCausalLM(_qwen2()).to(torch.bfloat16)
    m.save_pretrained(str(tmp_path), max_shard_size="16KB")
    shards = sorted(n for n in os.listdir(tmp_path)
                    if n.endswith(".safetensors"))
    assert len(shards) > 1 and os.path.exists(
        tmp_path / "model.safetensors.index.json")
    got = builder._load_torch_state(str(tmp_path))
    want = {}
    for n in shards:
        with safe_open(str(tmp_path / n), framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) and got[k].dtype == torch.bfloat16
               for k in want)
    # an index naming a tensor no shard holds
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    index["weight_map"]["lost.weight"] = shards[0]
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump(index, f)
    with pytest.raises(KeyError, match="lost.weight"):
        builder._load_torch_state(str(tmp_path))


def _header_file(path, header, data=b"\0" * 16):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + data)
    return path


@pytest.mark.parametrize("case", ["truncated", "overlap", "past_end",
                                  "shape", "dtype", "header"])
def test_reader_rejects_malformed_files(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    if case == "truncated":
        save_file({"a": torch.ones(64)}, path)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4)
        match = "offsets"
    else:
        e = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
        header = {
            "overlap": {"a": e, "b": dict(e, data_offsets=[4, 12])},
            "past_end": {"a": dict(e, shape=[8], data_offsets=[0, 32])},
            "shape": {"a": dict(e, shape=[3])},
            "dtype": {"a": dict(e, dtype="F8_E4M3")},
            "header": {},
        }[case]
        if case == "header":
            with open(path, "wb") as f:
                f.write((1 << 20).to_bytes(8, "little") + b"{}")
        else:
            _header_file(path, header)
        match = {"overlap": "overlap", "past_end": "offsets",
                 "shape": "offsets", "dtype": "unknown dtype",
                 "header": "runs past"}[case]
    with pytest.raises(ValueError, match=match):
        read_safetensors(path)


def test_hf_modules_load_without_safetensors_transformers_ml_dtypes(tmp_path):
    """In a fresh interpreter where the three packages cannot be imported
    (the card's machine has none of them), the reader, interop/hf.py,
    models/builder.py and tools/import_hf.py load, and an HF directory
    converts."""
    torch.manual_seed(0)
    m = transformers.Qwen2ForCausalLM(_qwen2()).to(torch.bfloat16)
    m.save_pretrained(str(tmp_path / "hf"), max_shard_size="16KB")
    code = (
        "import sys\n"
        "for name in ('safetensors', 'transformers', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import llavamod_tpu_torch.interop.safetensors_io\n"
        "import llavamod_tpu_torch.interop.hf\n"
        "import llavamod_tpu_torch.models.builder as b\n"
        "import llavamod_tpu_torch.tools.import_hf as t\n"
        f"t.main(['--hf-path', {str(tmp_path / 'hf')!r}, '--output', "
        f"{str(tmp_path / 'native')!r}, '--device', 'cpu'])\n"
        f"cfg, model = b.load_model({str(tmp_path / 'native')!r}, "
        "device='cpu')\n"
        "print(cfg.llm.name, model.llm.embed.embedding.dtype)\n"
        "print(sorted(n for n in ('safetensors', 'transformers', "
        "'ml_dtypes', 'jax') if sys.modules.get(n) is not None))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "hf-qwen2 torch.bfloat16" and lines[-1] == "[]"


# ---------------------------------------------------------------------------
# load_pretrained_model on an HF LLaVA directory
# ---------------------------------------------------------------------------

def test_load_pretrained_model_needs_the_tower_from_vision_path(tmp_path):
    cfg, _, _, model = _tiny_llava(moe=True)
    out = str(tmp_path / "hf-llava")
    hf.export_hf_llava(out, cfg, model.state_dict())
    with pytest.raises(ValueError, match="vision_path"):
        builder.load_pretrained_model(out, device="cpu", tokenizer=object())
    tower_dir = str(tmp_path / "tiny-vit")       # the registered tiny name
    hf_tower = _hf_tower("clip", seed=12)
    hf_tower.save_pretrained(tower_dir)
    tok, model2, cfg2, pp, _ = builder.load_pretrained_model(
        out, device="cpu", tokenizer="tok", vision_path=tower_dir)
    assert tok == "tok" and cfg2.vision == cfg.vision
    assert cfg2.llm == cfg.llm.replace(name="hf-qwen2")
    want = hf.vision_params_from_hf(hf_tower.state_dict(), cfg.vision)
    assert all(torch.equal(v, want[k]) for k, v in
               hf.pick(model2.state_dict(), "vision").items())
    for k, v in model.state_dict().items():
        if not k.startswith("vision."):
            assert torch.equal(model2.state_dict()[k], v), k
