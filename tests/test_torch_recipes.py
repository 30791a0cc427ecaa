"""The port's recipes (llavamod_tpu_torch/recipes/{train,eval}/*.sh), the
copies of the JAX package's scripts/recipes:

  * the same 4 train and 14 eval recipes, by name;
  * each copy's `python -m` commands carry the same flags, in the same
    order, as its JAX recipe's, with only the module name changed, under
    the same environment variables (`recipe_commands` resolves them as bash
    does);
  * each train recipe's flags parse through the port's train/args.py
    dataclasses into what the JAX package's parser makes of them, and the
    module runs the stage the JAX recipe's runs; each eval command parses
    through the port's eval CLI parser;
  * no copy names the JAX package (`llavamod_tpu.` without `_torch`)."""

import os
import re

import pytest

from llavamod_tpu.train import args as jargs
from llavamod_tpu_torch.eval import cli as tcli
from llavamod_tpu_torch.recipes import RECIPES_DIR, STAGES, recipe_commands
from llavamod_tpu_torch.train import args as targs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECIPES = os.path.join(REPO, "scripts", "recipes")
ENV = {"MODEL_PATH": "/ckpt/llava-mod", "JSON_FILE": "/data/mix.json",
       "IMAGE_FOLDER": "/data/images", "REF_MLLM": "/ckpt/teacher"}
TRAIN = sorted(p.name for p in (RECIPES_DIR / "train").glob("*.sh"))
EVAL = sorted(p.name for p in (RECIPES_DIR / "eval").glob("*.sh"))
_STAGE_CLASSES = {"pretrain": [], "align": ["AlignArgs"], "dpo": ["DPOArgs"]}


def _port(kind, name):
    return os.path.join(REPO, "llavamod_tpu_torch", "recipes", kind, name)


def test_the_same_recipes_as_the_jax_package():
    assert len(TRAIN) == 4 and len(EVAL) == 14
    for kind, names in (("train", TRAIN), ("eval", EVAL)):
        jax_names = sorted(f for f in os.listdir(os.path.join(JAX_RECIPES,
                                                              kind))
                           if f.endswith(".sh"))
        assert names == jax_names, kind


@pytest.mark.parametrize("kind,name", [("train", n) for n in TRAIN]
                         + [("eval", n) for n in EVAL])
def test_a_copy_has_the_flags_of_its_jax_recipe(kind, name):
    got = recipe_commands(_port(kind, name), ENV)
    want = recipe_commands(os.path.join(JAX_RECIPES, kind, name), ENV)
    assert got and len(got) == len(want)
    for (gmod, gargv), (wmod, wargv) in zip(got, want):
        assert wmod.startswith("llavamod_tpu.")
        assert gmod == wmod.replace("llavamod_tpu.", "llavamod_tpu_torch.", 1)
        assert gargv == wargv
    text = open(_port(kind, name)).read()
    assert not re.search(r"llavamod_tpu\.", text)
    assert os.access(_port(kind, name), os.X_OK)


@pytest.mark.parametrize("name", TRAIN)
def test_a_train_recipe_parses_into_the_jax_dataclasses(name):
    (module, argv), = recipe_commands(_port("train", name), ENV)
    stage = STAGES[module]
    names = ["ModelArgs", "DataArgs", "TrainArgs"] + _STAGE_CLASSES[stage]
    got = targs.parse_into_dataclasses([getattr(targs, n) for n in names],
                                       argv)
    want = jargs.parse_into_dataclasses([getattr(jargs, n) for n in names],
                                        argv)
    for g, w in zip(got, want):
        assert vars(g) == vars(w), type(g).__name__
    assert got[1].data_path == [ENV["JSON_FILE"]]
    assert got[2].per_device_train_batch_size >= 1
    if name == "dense2dense_distillation.sh":
        # stage 2a: a dense student and no --train_modules (all of it trains)
        assert stage == "align" and got[3].policy_model_type == "dense"
        assert not got[0].train_modules and not got[0].moe_enable
        assert got[3].ref_model_name_or_path == ENV["REF_MLLM"]


@pytest.mark.parametrize("name", EVAL)
def test_an_eval_recipe_parses_through_the_eval_cli(name):
    commands = recipe_commands(_port("eval", name), ENV)
    parser = tcli.build_parser("cpu")
    for module, argv in commands:
        assert module == "llavamod_tpu_torch.eval.cli"
        ns = parser.parse_args(argv)
        assert ns.cmd == argv[0]
        if ns.cmd == "generate":
            assert ns.model_path == ENV["MODEL_PATH"]


def test_recipe_variables_resolve_as_bash_would(tmp_path):
    script = tmp_path / "r.sh"
    script.write_text(
        "#!/bin/bash\nset -e\nA=${A:-'one'}   # a comment\n"
        "B=${B:?}; C=${C:-${B}/sub}\nN=$(basename \"${B}\")\n"
        "python -m pkg.mod --a \"${A}\" \\\n    --c \"${C}\" --n ${N}\n"
        "echo done\n")
    assert recipe_commands(script, {"B": "/x/y"}) == [
        ("pkg.mod", ["--a", "one", "--c", "/x/y/sub", "--n", "y"])]
    assert recipe_commands(script, {"A": "two", "B": "/z", "C": "c"}) == [
        ("pkg.mod", ["--a", "two", "--c", "c", "--n", "z"])]
    with pytest.raises(ValueError, match="needs B"):
        recipe_commands(script, {})
