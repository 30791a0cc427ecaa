"""The port's trainer entry point (llavamod_tpu_torch/train/{run,args,
checkpoint}.py) on the CPU, at tiny sizes:

  * the repository's stage configs parse into the same argument dataclasses
    and the same TrainConfig as with the JAX package's parser;
  * the paper's chain pretrain -> align (dense -> 4-expert MoE inside the
    stage) -> dpo runs through `run_stage`, checkpoint to checkpoint, with
    gradient accumulation: stage 1 moves only the projector and writes
    mm_projector.bin, stage 2 writes an MoE model, stage 3 trains it;
  * a run stopped at a checkpoint (mid-accumulation) and auto-resumed ends
    with the parameters of an uninterrupted run;
  * mm_projector.bin written by either package loads into the other with
    equal arrays, and the files are byte for byte the same;
  * `main([...], device="cpu")` runs with an HF tokenizer directory;
  * the port's and the JAX package's `run_stage("pretrain")`, from one
    checkpoint and one dataset, log the same first losses (rel 1e-4);
  * every option the port does not run yet raises NotImplementedError
    naming its ROADMAP item."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from util_torch_port import tiny_llava_config, to_jax_llava

from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.train import args as jargs
from llavamod_tpu.train import checkpoint as jckpt
from llavamod_tpu.train import run as jrun
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models import builder as tbuilder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.train import args as targs_mod
from llavamod_tpu_torch.train import checkpoint as tckpt
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import (
    AlignArgs,
    DataArgs,
    DPOArgs,
    ModelArgs,
    TrainArgs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".json"))


@pytest.fixture(scope="module", autouse=True)
def _no_compile_cache():
    """The JAX run_stage below re-loads jitted train steps; keep it out of
    the persistent compilation cache, as tests/test_train_run.py does."""
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


class StubTok:
    """Character-level ids, no BOS (tests/test_train_run.py's stub)."""
    bos_token_id = None
    pad_token_id = 0

    def __call__(self, text):
        return type("R", (), {"input_ids": [ord(c) % 500 for c in text]})()


def _cfg():
    return tiny_llava_config(moe_num_experts=0, moe_layers=())


def _write_data(root, n=16, same=False):
    img_dir = root / "imgs"
    img_dir.mkdir(exist_ok=True)
    sft, pref = [], []
    for i in range(n):
        k = 0 if same else i
        name = f"img{k}.png"
        Image.new("RGB", (32, 32), (k * 10 % 255, 30, 40)).save(img_dir / name)
        human = {"from": "human", "value": "<image>\nwhat is this?"}
        answer = {"from": "gpt", "value": f"a red bus {k}"}
        sft.append({"image": name, "conversations": [human, answer]})
        pref.append({"image": name, "chosen": [human, answer],
                     "rejected": [human, {"from": "gpt", "value": "nothing"}]})
    (root / "sft.json").write_text(json.dumps(sft))
    (root / "dpo.json").write_text(json.dumps(pref))
    return str(root / "sft.json"), str(root / "dpo.json"), str(img_dir)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One tiny dense checkpoint in both formats (the same weights), and
    the data."""
    root = tmp_path_factory.mktemp("run")
    cfg = _cfg()
    jcfg = to_jax_llava(cfg)
    params = jllava.init(jcfg, jax.random.PRNGKey(0))
    jdir = str(root / "jax_base")
    jbuilder.save_model(jdir, jcfg, params)
    model = tllava.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(params))
    tdir = str(root / "base")
    tbuilder.save_model(tdir, model)
    sft, dpo, imgs = _write_data(root)
    return dict(root=root, jax=jdir, port=tdir, sft=sft, dpo=dpo, imgs=imgs)


def _targs(out, **kw):
    base = dict(output_dir=str(out), per_device_train_batch_size=4,
                max_steps=4, gradient_accumulation_steps=2, logging_steps=1,
                save_steps=100, model_max_length=64,
                dataloader_num_workers=0, compute_dtype="float32",
                remat=False, vocab_chunk=128, learning_rate=1e-3,
                warmup_ratio=0.0)
    base.update(kw)
    return TrainArgs(**base)


def _lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _info(out):
    with open(os.path.join(out, "run_info.json")) as f:
        return json.load(f)


def _state(path):
    return torch.load(os.path.join(path, "model.pt"), weights_only=True)


# ---------------------------------------------------------------------------
# arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_parse_the_same(name):
    path = os.path.join(REPO, "configs", name)
    stage = {"pretrain": "pretrain", "dense2sparse": "align",
             "preference": "dpo"}[name.split("_")[0]]
    extra = {"align": ("AlignArgs", "align"), "dpo": ("DPOArgs", "dpo")}
    names = ["ModelArgs", "DataArgs", "TrainArgs"]
    if stage in extra:
        names.append(extra[stage][0])
    argv = ["--config", path, "--learning_rate", "0.5", "--max_steps", "7",
            "--train_modules", "wg", "mlp.up_proj"]
    got = targs_mod.parse_into_dataclasses(
        [getattr(targs_mod, n) for n in names], argv)
    want = jargs.parse_into_dataclasses([getattr(jargs, n) for n in names],
                                        argv)
    for g, w in zip(got, want):
        assert vars(g) == vars(w), type(g).__name__
    assert got[2].learning_rate == 0.5    # the command line wins
    with open(path) as f:
        config = json.load(f)
    assert got[2].per_device_train_batch_size == \
        config["per_device_train_batch_size"]
    margs = got[0]
    kw = {extra[stage][1]: got[3]} if stage in extra else {}
    jkw = {extra[stage][1]: want[3]} if stage in extra else {}
    tc = targs_mod.train_config_from_args(stage, got[2], 100, margs, **kw)
    jc = jargs.train_config_from_args(stage, want[2], 100, want[0], **jkw)
    assert vars(tc) == vars(jc)
    assert tc.total_steps == 100 // got[2].gradient_accumulation_steps


# ---------------------------------------------------------------------------
# the three stages
# ---------------------------------------------------------------------------

def test_three_stage_chain_runs_on_the_cpu(dirs):
    root = dirs["root"]
    out1, out2, out3 = (str(root / f"out{i}") for i in (1, 2, 3))
    data = dict(image_folder=dirs["imgs"])
    m1 = trun.run_stage(
        "pretrain", ModelArgs(model_name_or_path=dirs["port"], version="plain",
                              tune_mm_mlp_adapter=True),
        DataArgs(data_path=[dirs["sft"]], **data), _targs(out1, remat=True),
        tokenizer=StubTok(), device="cpu")
    before, after = _state(dirs["port"]), _state(out1)
    assert all(torch.equal(before[k], after[k]) == (not k.startswith("projector"))
               for k in before)
    proj = tckpt.load_mm_projector(os.path.join(out1, "mm_projector.bin"))
    assert all(torch.equal(v, after["projector." + k]) for k, v in proj.items())

    m2 = trun.run_stage(
        "align", ModelArgs(version="qwen", moe_enable=True,
                           train_modules=["mlp.gate_proj", "mlp.up_proj",
                                          "mlp.down_proj", "wg"]),
        DataArgs(data_path=[dirs["sft"]], **data),
        _targs(out2, model_max_length=256, group_by_modality_length=True),
        salign=AlignArgs(policy_model_name_or_path=out1,
                         ref_model_name_or_path=dirs["port"],
                         loss_type="kd_lm", moe_loss_enable=True),
        tokenizer=StubTok(), device="cpu")
    cfg2, model2 = tbuilder.load_model(out2, device="cpu")
    assert cfg2.llm.is_moe and cfg2.llm.moe_num_experts == 4
    assert "llm.layers.0.mlp.experts.up" in model2.state_dict()

    m3 = trun.run_stage(
        "dpo", ModelArgs(version="qwen"),
        DataArgs(data_path=[dirs["dpo"]], **data),
        _targs(out3, model_max_length=256, per_device_train_batch_size=2,
               remat=True),
        sdpo=DPOArgs(policy_model_name_or_path=out2,
                     ref_model_name_or_path=dirs["port"], loss_type="kto_pair",
                     moe_loss_enable=True),
        tokenizer=StubTok(), device="cpu")
    for out, m in ((out1, m1), (out2, m2), (out3, m3)):
        lines = _lines(out)
        assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
        assert all(np.isfinite(v) for ln in lines for v in ln.values())
        assert m == {k: v for k, v in lines[-1].items()
                     if k not in ("step", "sec_per_step")}
        info = _info(out)
        assert (info["microbatches"], info["optimizer_updates"]) == (4, 2)
    assert m2["num_tokens"] > 1 and m2["loss/align"] > 0
    assert "loss/moe_balance" in m3 and m3["logps/chosen"] < 0
    assert tbuilder.load_model(out3, device="cpu")[0].llm.is_moe


def test_auto_resume_mid_accumulation_matches_an_uninterrupted_run(
        tmp_path, dirs):
    sft, _, imgs = _write_data(tmp_path, n=4, same=True)   # every batch alike
    kw = dict(max_steps=4, gradient_accumulation_steps=2, save_steps=3,
              save_total_limit=1)

    def run(out):
        return trun.run_stage(
            "pretrain", ModelArgs(model_name_or_path=dirs["port"],
                                  version="plain", tune_mm_mlp_adapter=True),
            DataArgs(data_path=[sft], image_folder=imgs), _targs(out, **kw),
            tokenizer=StubTok(), device="cpu")

    whole, cut = tmp_path / "whole", tmp_path / "cut"
    run(whole)
    assert sorted(os.listdir(whole / "checkpoint-3")) == ["mm_projector.bin",
                                                          "state.pt"]
    saved = torch.load(whole / "checkpoint-3" / "state.pt", weights_only=True)
    assert saved["step"] == 3 and saved["opt"]["mini_step"] == 1
    # the interrupted run: only its checkpoint at step 3 survives
    cut.mkdir()
    os.rename(whole / "checkpoint-3", cut / "checkpoint-3")
    run(cut)
    assert _info(cut)["resumed_from"] == str(cut / "checkpoint-3")
    assert _info(cut)["microbatches"] == 1
    assert _info(cut)["optimizer_updates"] == _info(whole)[
        "optimizer_updates"] == 2
    a, b = _state(whole), _state(cut)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)
    assert not torch.equal(a["projector.layers.0.kernel"],
                           _state(dirs["port"])["projector.layers.0.kernel"])


@pytest.mark.parametrize("kind", ["linear", "mlp2x_gelu", "mlp3x_gelu"])
def test_mm_projector_bin_interchanges_with_jax(tmp_path, kind):
    cfg = tiny_llava_config().replace(projector_type=kind)
    jcfg = to_jax_llava(cfg)
    jproj = jax.device_get(jllava.init(jcfg, jax.random.PRNGKey(3))["projector"])
    model = tllava.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model.projector, jproj)
    # torch.save names the archive after the file: one name in two dirs
    jpath, tpath = (str(tmp_path / d / "mm_projector.bin") for d in "jt")
    jckpt.save_mm_projector(jpath, jproj, kind)
    tckpt.save_mm_projector(tpath, model.projector.state_dict(), kind)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    for path in (jpath, tpath):
        got = tckpt.load_mm_projector(path, kind)
        want = jckpt.load_mm_projector(path, kind)
        flat = {k: np.asarray(v) for k, v in
                _flatten(want).items()}
        assert got.keys() == flat.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)
            np.testing.assert_array_equal(
                v.numpy(), model.projector.state_dict()[k].numpy())


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def test_main_runs_with_a_tokenizer_directory(tmp_path, dirs):
    from util_tokenizer import make_tiny_tokenizer

    model_dir = str(tmp_path / "model")
    tbuilder.save_model(model_dir, tbuilder.load_model(dirs["port"],
                                                       device="cpu")[1])
    make_tiny_tokenizer(model_dir)
    out = str(tmp_path / "out")
    trun.main(["--stage", "pretrain", "--model_name_or_path", model_dir,
               "--version", "plain", "--tune_mm_mlp_adapter", "true",
               "--data_path", dirs["sft"], "--image_folder", dirs["imgs"],
               "--output_dir", out, "--max_steps", "2",
               "--per_device_train_batch_size", "4",
               "--model_max_length", "64", "--dataloader_num_workers", "2",
               "--compute_dtype", "float32", "--vocab_chunk", "128",
               "--profile_steps", "1"],
              device="cpu")
    assert len(_lines(out)) == 2 and _info(out)["optimizer_updates"] == 2
    assert os.path.exists(os.path.join(out, "mm_projector.bin"))
    with open(os.path.join(out, "profile", "trace.json")) as f:
        assert "traceEvents" in json.load(f)   # the second step, traced


def test_pretrain_run_stage_logs_the_losses_of_jax(tmp_path, dirs):
    kw = dict(max_steps=2, gradient_accumulation_steps=1)
    margs = dict(version="plain", tune_mm_mlp_adapter=True)
    data = dict(data_path=[dirs["sft"]], image_folder=dirs["imgs"])
    trun.run_stage("pretrain", ModelArgs(model_name_or_path=dirs["port"],
                                         **margs),
                   DataArgs(**data), _targs(tmp_path / "port", **kw),
                   tokenizer=StubTok(), device="cpu")
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=dirs["jax"],
                                               **margs),
                   jargs.DataArgs(**data),
                   jargs.TrainArgs(**vars(_targs(tmp_path / "jax", **kw))),
                   tokenizer=StubTok())
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "loss/lm", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("option,item", [
    (dict(margs=dict(lora_enable=True)), 6),
    (dict(margs=dict(s2=True)), 6),
    (dict(margs=dict(video_tower="frames")), 6),
    (dict(targs=dict(fused_update=True)), 4),
    (dict(targs=dict(optimizer="adafactor")), 4),
    (dict(targs=dict(data_parallel=2)), 9),
    (dict(targs=dict(expert_parallel=2)), 9),
    (dict(targs=dict(sequence_parallel=True)), 9),
    (dict(model="hf_dir"), 7),
    (dict(model="tiktoken_dir"), 7),
], ids=["lora", "s2", "video", "fused_update", "adafactor", "data_parallel",
        "expert_parallel", "sequence_parallel", "hf_dir", "tiktoken"])
def test_unported_options_raise_with_their_roadmap_item(tmp_path, dirs,
                                                        option, item):
    model = dirs["port"]
    if option.get("model") == "hf_dir":
        model = str(tmp_path)
        (tmp_path / "config.json").write_text("{}")
    if option.get("model") == "tiktoken_dir":
        model = str(tmp_path)
        (tmp_path / "qwen.tiktoken").write_text("")
    margs = ModelArgs(model_name_or_path=model, **option.get("margs", {}))
    salign = AlignArgs(ref_model_name_or_path=dirs["port"],
                       **option.get("salign", {}))
    tok = None if option.get("model") == "tiktoken_dir" else StubTok()
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, item {item}"):
        trun.run_stage("align", margs,
                       DataArgs(data_path=[dirs["sft"]],
                                image_folder=dirs["imgs"]),
                       _targs(tmp_path / "out", **option.get("targs", {})),
                       salign=salign, tokenizer=tok, device="cpu")
