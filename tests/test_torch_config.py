"""The port's config dataclasses against the JAX package's: same fields,
same defaults, same presets, same derived properties."""

import dataclasses

import pytest

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llm import config as jconfig
from llavamod_tpu.models.vision import vit as jvit
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.llm import config as tconfig
from llavamod_tpu_torch.models.vision import vit as tvit


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("jcls,tcls", [
    (jconfig.DecoderConfig, tconfig.DecoderConfig),
    (jvit.VisionConfig, tvit.VisionConfig),
    (jllava.LlavaConfig, tllava.LlavaConfig),
], ids=["decoder", "vision", "llava"])
def test_dataclass_fields_and_defaults(jcls, tcls):
    assert _fields(tcls) == _fields(jcls)


@pytest.mark.parametrize("name", ["QWEN1_5_1_8B", "QWEN2_0_5B", "QWEN1_5_7B"])
def test_llm_presets(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.rotary_dim, t.is_moe) == (j.head_dim, j.rotary_dim,
                                                    j.is_moe)
    assert tconfig.llm_configs.get(t.name) is t
    assert tconfig.llm_configs.get(name.lower()) is t  # the alias


def test_train_config_fields_and_defaults():
    from llavamod_tpu.train.config import TrainConfig as JTrainConfig
    from llavamod_tpu_torch.train.config import TrainConfig

    assert _fields(TrainConfig) == _fields(JTrainConfig)
    kw = dict(stage="align", align_loss_type="kd_lm", kd_vocab_limit=151936,
              train_modules=("/gate", "/up", "/down", "router"))
    assert dataclasses.asdict(TrainConfig(**kw).replace(remat=False)) == \
        dataclasses.asdict(JTrainConfig(**kw).replace(remat=False))


@pytest.mark.parametrize("name", ["ModelArgs", "DataArgs", "TrainArgs",
                                  "AlignArgs", "DPOArgs"])
def test_train_args_fields_and_defaults(name):
    """The trainer's CLI dataclasses: same fields, same order, same
    defaults (a default_factory compares by the value it makes)."""
    from llavamod_tpu.train import args as jargs
    from llavamod_tpu_torch.train import args as targs

    def fields(cls):
        return [(f.name, f.default_factory() if f.default_factory
                 is not dataclasses.MISSING else f.default, str(f.type))
                for f in dataclasses.fields(cls)]

    assert fields(getattr(targs, name)) == fields(getattr(jargs, name))


def test_vision_presets_and_tiny_configs():
    assert dataclasses.asdict(tvit.CLIP_VIT_L_336) == dataclasses.asdict(
        jvit.CLIP_VIT_L_336)
    tv, jv = tvit.tiny_vision_config(), jvit.tiny_vision_config()
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
    for prop in ("grid", "num_patches", "seq_len", "head_dim"):
        assert getattr(tvit.CLIP_VIT_L_336, prop) == getattr(
            jvit.CLIP_VIT_L_336, prop)
    kw = dict(moe_num_experts=4, moe_layers=(0,), head_dim=32,
              partial_rotary_factor=0.5)
    assert dataclasses.asdict(tconfig.tiny_config(**kw)) == dataclasses.asdict(
        jconfig.tiny_config(**kw))


def test_llava_derived_properties_and_moe_layers():
    from llavamod_tpu.models.llm.upcycle import moe_layer_indices

    for mode in ("sparse", "dense", "first_half", "second_half"):
        assert tconfig.moe_layer_indices(mode, 24) == moe_layer_indices(mode, 24)
    llm = tconfig.QWEN1_5_1_8B.replace(
        moe_num_experts=4, moe_layers=tconfig.moe_layer_indices("sparse", 24))
    t = tllava.LlavaConfig(llm=llm, vision=tvit.CLIP_VIT_L_336)
    j = jllava.LlavaConfig(llm=jconfig.QWEN1_5_1_8B.replace(
        moe_num_experts=4, moe_layers=tuple(range(24))[::2]),
        vision=jvit.CLIP_VIT_L_336)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_image_tokens == j.num_image_tokens == 576
    assert t.vision_feature_dim == j.vision_feature_dim
    assert t.llm.is_moe and t.llm.moe_layers == (0, 2, 4, 6, 8, 10, 12, 14,
                                                 16, 18, 20, 22)


def test_builder_config_roundtrip_reads_the_jax_file(tmp_path):
    """The port reads the llavamod_config.json the JAX builder writes."""
    import json

    from llavamod_tpu.models.builder import config_to_dict as jto_dict
    from llavamod_tpu_torch.models.builder import (
        config_from_dict,
        config_to_dict,
    )

    j = jllava.LlavaConfig(llm=jconfig.tiny_config(moe_num_experts=4,
                                                   moe_layers=(0,)),
                           vision=jvit.tiny_vision_config())
    d = json.loads(json.dumps(jto_dict(j)))
    t = config_from_dict(d)
    assert config_to_dict(t) == jto_dict(j)


@pytest.mark.parametrize("argv,differs", [
    (["--ref_quant", "", "--policy_head_quant", "false"],
     {"ref_quant": ("", "int8_head"), "policy_head_quant": (False, True)}),
    (["--gradient_accumulation_steps", "1", "--learning_rate", "2e-05"],
     {"gradient_accumulation_steps": (1, 8)}),
    (["--max_steps", "7", "--train_modules", "wg"], {}),
    ([], {}),
], ids=["undo-int8", "default-valued", "non-default", "config-only"])
def test_command_line_flags_win_over_the_config(argv, differs):
    """The port's parser lets every flag the command line gives win over
    --config; the JAX parser lets the config overwrite a flag whose value
    equals its default.  That is the one difference: every other field
    parses the same."""
    import os

    from llavamod_tpu.train import args as jargs
    from llavamod_tpu_torch.train import args as targs

    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "dense2sparse_qwen2_0_5b.json")
    names = ["ModelArgs", "DataArgs", "TrainArgs", "AlignArgs"]
    full = ["--config", config] + argv
    got = targs.parse_into_dataclasses([getattr(targs, n) for n in names],
                                       full)
    want = jargs.parse_into_dataclasses([getattr(jargs, n) for n in names],
                                        full)
    seen = {}
    for g, w in zip(got, want):
        for k, v in vars(w).items():
            if vars(g)[k] != v:
                seen[k] = (vars(g)[k], v)
    assert seen == differs
