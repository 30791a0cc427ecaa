"""The port's checkpoint tools (llavamod_tpu_torch/tools) against the JAX
package's on the same inputs, on the CPU:

  * `import_hf` on a qwen2 directory (safetensors), an MPT directory and an
    HF LLaVA export (projector and an embedded tower restored): the same
    llavamod_config.json as JAX's tool, the LLM (and what the checkpoint
    holds) bitwise JAX's, logits at 2e-3 against transformers;
  * `extract_mm_projector` on a native directory and on an HF one: the same
    mm_projector.bin contents as JAX's tool, loadable by
    train/checkpoint.py;
  * `consolidate` of an HF LLaVA export into a native directory: JAX's
    config and weights; with `--base`, a LoRA adapter merged onto that HF
    export as JAX's `merge_lora` tool merges it;
  * `delta` make and apply, with a resized vocabulary: bitwise JAX's."""

import json
import os

import numpy as np
import pytest
import torch
import transformers
from util_tokenizer import make_tiny_tokenizer
from util_torch_port import tiny_llava_config, to_jax_llava

import jax

from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.vision import vit as jvit
from llavamod_tpu.tools import consolidate as jconsolidate
from llavamod_tpu.tools import delta as jdelta
from llavamod_tpu.tools import extract_mm_projector as jextract
from llavamod_tpu.tools import import_hf as jimport_hf
from llavamod_tpu.tools import merge_lora as jmerge_lora
from llavamod_tpu_torch.interop import hf
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models import lora as tlora
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.vision import vit as tvit
from llavamod_tpu_torch.tools import consolidate, delta, import_hf
from llavamod_tpu_torch.tools import extract_mm_projector as extract
from llavamod_tpu_torch.train import checkpoint as tckpt


@pytest.fixture(scope="module", autouse=True)
def _tiny_tower_name():
    """The tools name towers by registry name: register the tiny one in
    both packages, as tests/test_import_hf_tool.py does."""
    for registry, make in ((tvit.vision_configs, tvit.tiny_vision_config),
                           (jvit.vision_configs, jvit.tiny_vision_config)):
        if "tiny-vit" not in registry:
            registry.register("tiny-vit", make())
        if "tiny-clip" not in registry:      # HF CLIP: no patch bias
            registry.register("tiny-clip", make(name="tiny-clip",
                                                patch_bias=False))


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


def _native(path):
    """(config dict, {key: f32 ndarray}) of a native directory of either
    package."""
    with open(os.path.join(path, builder.CONFIG_NAME)) as f:
        cfg = json.load(f)
    if os.path.exists(os.path.join(path, builder.WEIGHTS_NAME)):
        state = torch.load(os.path.join(path, builder.WEIGHTS_NAME),
                           weights_only=True)
        return cfg, {k: v.float().numpy() for k, v in state.items()}
    return cfg, _flat(jax.device_get(jbuilder.load_model(path)[1]))


def _same(a, b, groups=("llm", "projector", "vision")):
    keys = [k for k in b if k.split(".")[0] in groups]
    assert keys and set(keys) == {k for k in a if k.split(".")[0] in groups}
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _tiny_llava(seed=4, vision=None, **llm):
    cfg = tiny_llava_config(**{"moe_num_experts": 0, "moe_layers": (),
                               **llm})
    if vision is not None:
        cfg = cfg.replace(vision=vision)
    jcfg = to_jax_llava(cfg)
    params = jax.device_get(jllava.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x))
        .astype(np.float32), params)
    model = tllava.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, params)
    return cfg, jcfg, params, model


def _hf_llm(kind, path):
    torch.manual_seed(0)
    if kind == "qwen2":
        m = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, tie_word_embeddings=False))
    else:
        m = transformers.MptForCausalLM(transformers.MptConfig(
            d_model=32, n_heads=4, n_layers=2, expansion_ratio=4,
            max_seq_len=64, vocab_size=96))
    m.eval().save_pretrained(path)
    return m


@pytest.mark.parametrize("kind", ["qwen2", "mpt", "llava"])
def test_import_hf_equals_jax_tool(tmp_path, kind):
    src = str(tmp_path / "hf")
    if kind == "llava":
        cfg, jcfg, params, model = _tiny_llava(vision=tvit.tiny_vision_config(
            name="tiny-clip", patch_bias=False))
        hf.export_hf_llava(src, cfg, model.state_dict())
        # a tower embedded as the reference's full checkpoints carry it
        state = torch.load(os.path.join(src, "pytorch_model.bin"),
                           weights_only=True)
        hf_tower = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14))
        state.update({"vision_tower.vision_tower." + k: v for k, v in
                      hf_tower.state_dict().items()})
        torch.save(state, os.path.join(src, "pytorch_model.bin"))
        groups = ("llm", "projector", "vision")
    else:
        hf_model = _hf_llm(kind, src)
        groups = ("llm",)
    argv = ["--hf-path", src, "--vision-tower", "tiny-vit"]
    jimport_hf.main(argv + ["--output", str(tmp_path / "jax")])
    import_hf.main(argv + ["--output", str(tmp_path / "port"),
                           "--device", "cpu"])
    jc, jw = _native(str(tmp_path / "jax"))
    tc, tw = _native(str(tmp_path / "port"))
    assert tc == jc
    _same(tw, jw, groups)
    if kind != "llava":
        cfg, m = builder.load_model(str(tmp_path / "port"), device="cpu")
        ids = np.random.RandomState(0).randint(0, 96, size=(1, 9))
        with torch.no_grad():
            want = hf_model(torch.tensor(ids)).logits.numpy()
            out = tdecoder.forward(m.llm, cfg.llm, input_ids=torch.tensor(ids),
                                   attn_impl="xla")
            got = tdecoder.logits_from_hidden(m.llm, cfg.llm, out.hidden)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_extract_mm_projector_equals_jax_tool(tmp_path):
    cfg, jcfg, params, model = _tiny_llava()
    jdir = jbuilder.save_model(str(tmp_path / "jax"), jcfg, params)
    tdir = builder.save_model(str(tmp_path / "port"), model)
    hf_dir = hf.export_hf_llava(str(tmp_path / "hf"), cfg, model.state_dict())
    for src in (tdir, hf_dir):
        name = os.path.basename(src)
        got = extract.main(["--model-path", src, "--output",
                            str(tmp_path / "t" / name / "mm_projector.bin")])
        want = jextract.extract_mm_projector(
            jdir if src == tdir else hf_dir,
            str(tmp_path / "j" / name / "mm_projector.bin"))
        a = torch.load(got, weights_only=True)
        b = torch.load(want, weights_only=True)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
        loaded = tckpt.load_mm_projector(got, cfg.projector_type)
        for k, v in model.projector.state_dict().items():
            assert torch.equal(loaded[k], v), k


def test_consolidate_hf_to_native_equals_jax_tool(tmp_path):
    cfg, jcfg, params, model = _tiny_llava(moe_num_experts=2,
                                           moe_layers=(0,))
    src = hf.export_hf_llava(str(tmp_path / "hf"), cfg, model.state_dict())
    make_tiny_tokenizer(src)     # the JAX tool loads a tokenizer too
    jconsolidate.main(["--src", src, "--dst", str(tmp_path / "jax")])
    consolidate.main(["--src", src, "--dst", str(tmp_path / "port"),
                      "--device", "cpu"])
    jc, jw = _native(str(tmp_path / "jax"))
    tc, tw = _native(str(tmp_path / "port"))
    assert tc == jc and not any(k.startswith("vision.") for k in tw)
    _same(tw, jw, ("llm", "projector"))
    cfg2, m2 = builder.load_model(str(tmp_path / "port"), device="cpu",
                                  fill_missing_seed=0)
    assert cfg2.llm == cfg.llm.replace(name="hf-qwen2")
    # --base (once refused as ROADMAP item 6): --src is a LoRA adapter,
    # merged onto the HF base as JAX's merge_lora tool merges it (1e-6:
    # the rank-r products run in another order)
    lcfg = tlora.LoraConfig(r=4, alpha=8)
    lora = tlora.init_lora(m2, lcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in lora.parameters():
            p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    adapter = tlora.save_lora_adapter(str(tmp_path / "adapter"), lora, lcfg)
    consolidate.main(["--src", adapter, "--base", src, "--dst",
                      str(tmp_path / "merged"), "--device", "cpu"])
    jmerge_lora.merge_lora_weights(adapter, src, str(tmp_path / "jmerged"))
    _, got = _native(str(tmp_path / "merged"))
    _, want = _native(str(tmp_path / "jmerged"))
    assert got.keys() == want.keys() and "llm.layers.0.attn.wq" in lora.targets
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert (k in lora.targets) != np.array_equal(got[k], tw[k]), k


def test_delta_make_and_apply_equal_jax_tool(tmp_path):
    """Base with a 512-token vocabulary, target with 528 (new special-token
    rows): `make` subtracts the base from the top-left block, `apply`
    adds it back, as JAX's tool does."""
    _, jb_cfg, jb, base = _tiny_llava(seed=1)
    _, jt_cfg, jt, target = _tiny_llava(seed=2, vocab_size=528)
    dirs = {}
    for name, jcfg, params, model in (("base", jb_cfg, jb, base),
                                      ("target", jt_cfg, jt, target)):
        dirs["j" + name] = jbuilder.save_model(str(tmp_path / "j" / name),
                                               jcfg, params)
        dirs["t" + name] = builder.save_model(str(tmp_path / "t" / name),
                                              model)
    for side, main in (("j", jdelta.main),
                       ("t", lambda a: delta.main(a + ["--device", "cpu"]))):
        main(["make", "--base", dirs[side + "base"], "--target",
              dirs[side + "target"], "--delta", str(tmp_path / side / "d")])
        main(["apply", "--base", dirs[side + "base"], "--delta",
              str(tmp_path / side / "d"), "--target",
              str(tmp_path / side / "back")])
    for out in ("d", "back"):
        jc, jw = _native(str(tmp_path / "j" / out))
        tc, tw = _native(str(tmp_path / "t" / out))
        assert tc == jc
        _same(tw, jw)
    d = _native(str(tmp_path / "t" / "d"))[1]["llm.embed.embedding"]
    assert d.shape == (528, 64)
    np.testing.assert_array_equal(            # new rows pass through
        d[512:], target.state_dict()["llm.embed.embedding"][512:].numpy())
    with pytest.raises(ValueError, match="dimension mismatch"):
        delta.make_delta({"llm.layers.0.attn.wq": torch.zeros(2, 2)},
                         {"llm.layers.0.attn.wq": torch.zeros(3, 2)})
