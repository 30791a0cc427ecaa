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
  * `run_stage` starts from an HF LLaVA directory (the port's
    `export_hf_llava` of the tiny checkpoint; the tower filled from the
    seed) and logs the first losses of the JAX package's run from the same
    directory (rel 1e-4; the JAX fill is handed the port's seeded tower,
    since the two packages draw different numbers from one seed); and from
    a qwen-1.0 HF directory with its tiktoken vocabulary, whose tokenizer
    `load_tokenizer` picks (eos and pad <|endoftext|>);
  * stage 2a (dense -> dense, the dense2dense recipe's options) through
    both packages' `run_stage("align")` from one policy and one teacher:
    the same losses for 3 steps (rel 1e-4) and the same saved weights (rel
    1e-4 over each tensor);
  * the port's and the JAX package's `run_stage("pretrain")`, from one
    checkpoint and one dataset, log the same first losses (rel 1e-4), with
    AdamW on the projector and with `--optimizer adafactor` on the whole
    LLM (the JAX trainer with `prestack_layers=False`: the port's
    Adafactor blocks are single matrices);
  * `--fused_update` runs the align stage with accumulation 2: one update
    per 2 folded microbatches, the global-gating warning, and a run
    stopped at a checkpoint and auto-resumed ends with the parameters of
    an uninterrupted one;
  * every option the port does not run yet (tensor, sequence and pipeline
    parallelism; LoRA and the fused step under torch.distributed) raises
    NotImplementedError naming its ROADMAP item, a mesh the processes
    cannot fill raises ValueError; LoRA, S2 and the video projector run."""

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


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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


def test_auto_resume_continues_the_data_where_its_checkpoint_left_it(
        tmp_path, dirs):
    """With distinct batches, a run resumed from its checkpoint after
    update 1 trains update 2 on the batches the uninterrupted run saw
    there (the reference's Trainer skips the seen batches; restarting the
    order would train on update 1's batches again), so it logs the same
    losses and ends with the same weights."""
    sft, _, imgs = _write_data(tmp_path, n=16)
    kw = dict(max_steps=4, gradient_accumulation_steps=2, save_steps=2,
              save_total_limit=1, per_device_train_batch_size=2)

    def run(out):
        return trun.run_stage(
            "pretrain", ModelArgs(model_name_or_path=dirs["port"],
                                  version="plain", tune_mm_mlp_adapter=True),
            DataArgs(data_path=[sft], image_folder=imgs), _targs(out, **kw),
            tokenizer=StubTok(), device="cpu")

    whole, cut = tmp_path / "whole", tmp_path / "cut"
    run(whole)
    cut.mkdir()
    os.rename(whole / "checkpoint-2", cut / "checkpoint-2")
    run(cut)
    a, b = _lines(whole), _lines(cut)
    assert _info(cut)["microbatches"] == 2 and len(b) == 2
    # the batches differ: microbatch 3 alone shows where the data resumed
    assert len({ln["num_tokens"] for ln in a}) > 1
    assert a[2]["loss"] != a[0]["loss"]
    for x, y in zip(a[2:], b):
        assert y["step"] == x["step"]
        for k in ("loss", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)
    sa, sb = _state(whole), _state(cut)
    for k in sa:
        np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)


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
        prof = json.load(f)                    # the second step, traced
    with open(os.path.join(out, "profile", "spans.json")) as f:
        spans = json.load(f)                   # its program spans
    step, = [s for s in spans if s["name"] == "train.step"]
    assert step["id"] == 1
    phases = {s["name"] for s in spans if s["parent"] == step["sid"]}
    assert phases == {"train.student_fwd", "train.loss", "train.backward",
                      "train.update"}
    # on the trace's clock: the profile shows the step's span by name, and
    # its record_function (entered first, left last) holds the span
    shown, = [e for e in prof["traceEvents"] if e.get("name") == "train.step"]
    t0_ns = prof["baseTimeNanoseconds"] + shown["ts"] * 1e3
    t1_ns = t0_ns + shown["dur"] * 1e3
    assert t0_ns <= step["start_ns"] + 1e6 and step["end_ns"] <= t1_ns + 1e6


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


def test_adafactor_run_stage_logs_the_losses_of_jax(tmp_path, dirs):
    kw = dict(max_steps=3, gradient_accumulation_steps=1,
              optimizer="adafactor", learning_rate=1e-2)
    margs = dict(version="plain", tune_mm_mlp_adapter=False)
    data = dict(data_path=[dirs["sft"]], image_folder=dirs["imgs"])
    trun.run_stage("pretrain", ModelArgs(model_name_or_path=dirs["port"],
                                         **margs),
                   DataArgs(**data), _targs(tmp_path / "port", **kw),
                   tokenizer=StubTok(), device="cpu")
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=dirs["jax"],
                                               **margs),
                   jargs.DataArgs(**data),
                   jargs.TrainArgs(**dict(vars(_targs(tmp_path / "jax", **kw)),
                                          prestack_layers=False)),
                   tokenizer=StubTok())
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "loss/lm", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got[2]["loss"] != got[0]["loss"]      # the updates moved it
    before, after = _state(dirs["port"]), _state(tmp_path / "port")
    assert not torch.equal(before["llm.layers.0.mlp.up"],
                           after["llm.layers.0.mlp.up"])


def test_stage_2a_dense_to_dense_logs_the_losses_and_weights_of_jax(
        tmp_path, dirs):
    """Stage 2a (the dense2dense recipe's options: a dense student, kd_lm,
    no --train_modules, so the whole LLM and the projector train) from one
    policy and one dense teacher in both formats: the port's and the JAX
    package's `run_stage("align")` log the same losses for 3 steps (rel
    1e-4) and save the same weights (rel 1e-4 over each tensor), the tower
    unchanged."""
    from llavamod_tpu_torch.models.builder import CONFIG_NAME
    from util_torch_port import flatten_numpy, matched_llava

    jcfg, jparams, teacher = matched_llava(_cfg(), seed=5)
    tteacher = tbuilder.save_model(str(tmp_path / "teacher"), teacher)
    jteacher = jbuilder.save_model(str(tmp_path / "jteacher"), jcfg, jparams)
    kw = dict(max_steps=3, gradient_accumulation_steps=1, learning_rate=1e-3,
              model_max_length=256)
    margs = dict(version="qwen")
    align = dict(policy_model_type="dense", ref_model_type="dense",
                 loss_type="kd_lm")
    data = dict(data_path=[dirs["sft"]], image_folder=dirs["imgs"])
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    trun.run_stage("align", ModelArgs(**margs), DataArgs(**data),
                   _targs(out, **kw),
                   salign=AlignArgs(policy_model_name_or_path=dirs["port"],
                                    ref_model_name_or_path=tteacher, **align),
                   tokenizer=StubTok(), device="cpu")
    jrun.run_stage("align", jargs.ModelArgs(**margs), jargs.DataArgs(**data),
                   jargs.TrainArgs(**vars(_targs(jout, **kw))),
                   salign=jargs.AlignArgs(
                       policy_model_name_or_path=dirs["jax"],
                       ref_model_name_or_path=jteacher, **align),
                   tokenizer=StubTok())
    got, want = _lines(out), _lines(jout)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k != "sec_per_step":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got[0]["num_tokens"] > 1 and got[0]["loss/align"] > 0
    assert got[2]["loss"] != got[0]["loss"]
    with open(os.path.join(out, CONFIG_NAME)) as f:
        assert not json.load(f)["llm"].get("moe_layers")     # still dense
    before, after = _state(dirs["port"]), _state(out)
    jafter = flatten_numpy(jax.device_get(jbuilder.load_model(jout)[1]))
    assert after.keys() == before.keys() == jafter.keys()
    for k, v in after.items():
        moved = not torch.equal(v, before[k])
        assert moved == (not k.startswith("vision.")), k
        # rel 1e-4 over each tensor: AdamW's normalised step moves an entry
        # whose gradient is near zero by up to lr whatever its rounding
        got_k = v.float().numpy()
        assert np.linalg.norm(got_k - jafter[k]) <= 1e-4 * np.linalg.norm(
            jafter[k]), k


def _unflatten(flat):
    """{'a.0.b': x} -> {'a': [{'b': x}]} (the JAX tree of a state dict)."""
    tree = {}
    for k, v in flat.items():
        node, parts = tree, k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v.numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def test_run_stage_from_an_hf_directory_logs_the_losses_of_jax(
        tmp_path, dirs, monkeypatch):
    from llavamod_tpu.models.vision import vit as jvit
    from llavamod_tpu_torch.interop.hf import export_hf_llava
    from llavamod_tpu_torch.models.vision import vit as tvit

    cfg, model = tbuilder.load_model(dirs["port"], device="cpu")
    hf_dir = export_hf_llava(str(tmp_path / "hf"), cfg, model.state_dict())
    for registry, tower in ((tvit.vision_configs, cfg.vision),
                            (jvit.vision_configs, to_jax_llava(cfg).vision)):
        if cfg.vision.name not in registry:   # the export names its tower
            registry.register(cfg.vision.name, tower)
    # the port fills the missing tower from the seed: hand JAX the same one
    seed = TrainArgs().seed
    seeded = tvit.init(cfg.vision, torch.Generator().manual_seed(seed), "cpu",
                       torch.float32).state_dict()
    fill = jrun._fill_missing

    def jax_fill(cfg_, params, missing, seed, dtype):
        assert missing == ["vision"] and seed == TrainArgs().seed
        params = fill(cfg_, params, missing, seed, dtype)
        params["vision"] = _unflatten(seeded)
        return params
    monkeypatch.setattr(jrun, "_fill_missing", jax_fill)

    kw = dict(max_steps=2, gradient_accumulation_steps=1)
    margs = dict(model_name_or_path=hf_dir, version="plain",
                 tune_mm_mlp_adapter=True)
    data = dict(data_path=[dirs["sft"]], image_folder=dirs["imgs"])
    trun.run_stage("pretrain", ModelArgs(**margs), DataArgs(**data),
                   _targs(tmp_path / "port", **kw), tokenizer=StubTok(),
                   device="cpu")
    jrun.run_stage("pretrain", jargs.ModelArgs(**margs),
                   jargs.DataArgs(**data),
                   jargs.TrainArgs(**vars(_targs(tmp_path / "jax", **kw))),
                   tokenizer=StubTok())
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "loss/lm", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    out = _state(tmp_path / "port")          # the tower as the seed made it
    assert all(torch.equal(out["vision." + k], v) for k, v in seeded.items())
    assert not torch.equal(out["projector.layers.0.kernel"],
                           model.state_dict()["projector.layers.0.kernel"])


def test_run_stage_with_a_qwen_v1_tiktoken_directory(tmp_path, dirs,
                                                      monkeypatch):
    """A qwen-1.0 HF directory (fused c_attn; its config names the tiny
    tower) with a qwen.tiktoken vocabulary and no tokenizer given: the
    trainer reads the vocabulary with the port's tiktoken tokenizer, whose
    pad id (<|endoftext|>, 151643) the collator pads with, so the model
    carries the Qwen vocabulary of 151,936."""
    import base64

    from golden.hf_family_refs import TinyQwenV1
    from safetensors.torch import save_file

    from llavamod_tpu_torch.interop import tiktoken_tokenizers as ttt
    from llavamod_tpu_torch.models.vision import vit as tvit

    if "tiny-vit" not in tvit.vision_configs:
        tvit.vision_configs.register("tiny-vit", tvit.tiny_vision_config())
    d = tmp_path / "qwen"
    d.mkdir()
    torch.manual_seed(0)
    oracle = TinyQwenV1(dict(vocab_size=151936, hidden_size=32,
                             intermediate_size=48, num_layers=2, num_heads=4,
                             rope_theta=10000.0, rms_norm_eps=1e-6))
    save_file({k: v.detach().clone() for k, v in oracle.state_dict().items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(
        model_type="qwen", vocab_size=151936, hidden_size=32,
        intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        seq_length=64, rotary_emb_base=10000.0, layer_norm_epsilon=1e-6,
        mm_image_tower="tiny-vit")))
    (d / "qwen.tiktoken").write_text("".join(
        base64.b64encode(bytes([b])).decode() + f" {b}\n"
        for b in range(256)))
    seen = []
    load = trun.load_tokenizer
    monkeypatch.setattr(trun, "load_tokenizer",
                        lambda margs: seen.append(load(margs)) or seen[-1])
    out = tmp_path / "out"
    last = trun.run_stage(
        "pretrain", ModelArgs(model_name_or_path=str(d), version="plain",
                              tune_mm_mlp_adapter=True),
        DataArgs(data_path=[dirs["sft"]], image_folder=dirs["imgs"]),
        _targs(out, vocab_chunk=151936), device="cpu")
    (tok,) = seen
    assert isinstance(tok, ttt.QWenV1Tokenizer)
    assert tok.pad_token_id == tok.eos_token_id == 151643
    lines = _lines(out)
    assert [ln["step"] for ln in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert last["num_tokens"] > 1 and _info(out)["optimizer_updates"] == 2
    cfg, model = tbuilder.load_model(str(out), device="cpu")
    assert cfg.llm.name == "hf-qwen" and cfg.llm.use_logn_attn
    assert torch.equal(model.llm.layers[0].attn.wq.detach(),
                       oracle.state_dict()["transformer.h.0.attn.c_attn"
                                           ".weight"][:32].t())


def _fused_align(out, dirs, sft, imgs, **kw):
    base = dict(max_steps=4, gradient_accumulation_steps=2,
                optimizer="adafactor", fused_update=True,
                model_max_length=256, learning_rate=1e-2)
    base.update(kw)
    return trun.run_stage(
        "align", ModelArgs(version="qwen", moe_enable=True,
                           train_modules=["mlp.gate_proj", "mlp.up_proj",
                                          "mlp.down_proj", "wg"]),
        DataArgs(data_path=[sft], image_folder=imgs), _targs(out, **base),
        salign=AlignArgs(policy_model_name_or_path=dirs["port"],
                         ref_model_name_or_path=dirs["port"],
                         loss_type="kd_lm", moe_loss_enable=True),
        tokenizer=StubTok(), device="cpu")


def test_fused_update_runs_the_align_stage(tmp_path, dirs):
    out = tmp_path / "fused"
    with pytest.warns(UserWarning, match="global gating"):
        last = _fused_align(out, dirs, dirs["sft"], dirs["imgs"])
    lines = _lines(out)
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert last["num_tokens"] > 1 and "loss/moe_balance" in last
    info = _info(out)
    assert (info["microbatches"], info["optimizer_updates"]) == (4, 2)
    cfg, model = tbuilder.load_model(str(out), device="cpu")
    assert cfg.llm.is_moe
    assert trun.refuse_unported(ModelArgs(), _targs(out, fused_update=True,
                                                    optimizer="adafactor")) \
        is None


def test_fused_auto_resume_matches_an_uninterrupted_run(tmp_path, dirs):
    sft, _, imgs = _write_data(tmp_path, n=4, same=True)   # every batch alike
    kw = dict(save_steps=1, save_total_limit=1)
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    with pytest.warns(UserWarning, match="global gating"):
        _fused_align(whole, dirs, sft, imgs, **kw)
    saved = torch.load(whole / "checkpoint-1" / "state.pt", weights_only=True)
    assert saved["step"] == 1
    assert saved["opt"]["default"]["count"] == 1
    cut.mkdir()
    os.rename(whole / "checkpoint-1", cut / "checkpoint-1")
    with pytest.warns(UserWarning, match="global gating"):
        _fused_align(cut, dirs, sft, imgs, **kw)
    assert _info(cut)["resumed_from"] == str(cut / "checkpoint-1")
    assert _info(cut)["microbatches"] == 2
    assert _info(cut)["optimizer_updates"] == _info(whole)[
        "optimizer_updates"] == 2
    a, b = _state(whole), _state(cut)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)
    assert _lines(cut)[-1]["loss"] == _lines(whole)[-1]["loss"]


PRESET = "tiny-dense-preset"     # a registered name: --s2 and
# --video_tower build a preset model (a directory keeps its saved config)


@pytest.mark.parametrize("option,item", [
    (dict(margs=dict(lora_enable=True, lora_r=4, lora_alpha=8)), 6),
    (dict(margs=dict(s2=True, s2_scales="28,56", model_name_or_path=PRESET,
                     image_tower="tiny-vit")), 6),
    (dict(margs=dict(video_tower="frames", model_name_or_path=PRESET,
                     image_tower="tiny-vit", video_global_proj=True)), 6),
    (dict(targs=dict(data_parallel=2)), "mesh"),
    (dict(targs=dict(expert_parallel=2)), "mesh"),
    (dict(targs=dict(sequence_parallel=True)), "runs"),
    (dict(targs=dict(tensor_parallel=2)), "mesh"),
    (dict(targs=dict(pipeline_parallel=2, fused_update=True,
                     optimizer="adafactor")), "fused_pipe"),
    (dict(margs=dict(lora_enable=True), env=True), "torchrun"),
    (dict(targs=dict(fused_update=True, optimizer="adafactor"), env=True),
     "torchrun"),
    (dict(margs=dict(lora_enable=True),
          targs=dict(fused_update=True, optimizer="adafactor")), "fused_lora"),
], ids=["lora", "s2", "video", "data_parallel", "expert_parallel",
        "sequence_parallel", "tensor_parallel", "pipeline_parallel",
        "lora_multi_process", "fused_multi_process", "fused_lora"])
def test_unported_options_raise_with_their_roadmap_item(tmp_path, dirs,
                                                        option, item,
                                                        monkeypatch):
    """A data, expert or tensor parallel mesh one process cannot fill raises
    ValueError, before anything is built; the fused step with LoRA, or
    under pipeline parallelism (item 14, ported: tests/test_torch_pipeline.py
    runs it under torch.distributed), is a ValueError, as in the JAX
    engine, the latter before anything is built; item 6's options, once
    refused the same way, run the align stage: LoRA writes `adapter/` and
    the merged model (its FFN weights moved, its tower not), S2 doubles the
    tower's feature width, and the video projector joins the model in stage
    1 (the align stage refuses it).  Item 13 is ported: --sequence_parallel
    without a tensor split runs the align stage as it would without it (the
    JAX engine turns it on only with --tensor_parallel > 1).  Item 15 is
    ported: LoRA and the fused step, once refused under torchrun, run the
    align stage under a one-rank torchrun environment (gloo, FSDP2 on both
    models) to its end."""
    from llavamod_tpu_torch.models.llm.config import llm_configs
    from llavamod_tpu_torch.models.vision import vit as tvit

    if PRESET not in llm_configs:
        llm_configs.register(PRESET, _cfg().llm)
    if "tiny-vit" not in tvit.vision_configs:
        tvit.vision_configs.register("tiny-vit", tvit.tiny_vision_config())
    margs = dict(model_name_or_path=dirs["port"])
    margs.update(option.get("margs", {}))
    # kd_lm: the teacher is the policy's own checkpoint, so the KD term
    # alone has no gradient
    salign = AlignArgs(ref_model_name_or_path=dirs["port"], loss_type="kd_lm",
                       **option.get("salign", {}))
    out = tmp_path / "out"
    targs = dict(model_max_length=256, **option.get("targs", {}))

    # the video projector trains in stage 1 (a teacher without one cannot
    # read the video rows of the distillation batch)
    stage = "pretrain" if margs.get("video_tower") else "align"

    def run():
        return trun.run_stage(
            stage, ModelArgs(**margs),
            DataArgs(data_path=[dirs["sft"]], image_folder=dirs["imgs"]),
            _targs(out, **targs), salign=salign, tokenizer=StubTok(),
            device="cpu")

    if option.get("env"):           # a one-rank torchrun environment
        for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(_free_port())).items():
            monkeypatch.setenv(k, v)
    if item == "mesh":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            run()
        assert not out.exists()               # nothing was built
        return
    if item in (13, 14, 15):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1, item {item}"):
            run()
        assert not out.exists()
        return
    if item == "fused_lora":
        with pytest.raises(ValueError, match="does not support LoRA"):
            run()
        return
    if item == "fused_pipe":
        with pytest.raises(ValueError, match="cannot run under "
                           "--pipeline_parallel; drop one of the two"):
            run()
        assert not out.exists()
        return
    last = run()
    assert last["num_tokens"] > 1 and np.isfinite(last["loss"])
    assert _info(out)["optimizer_updates"] == 2
    cfg, model = tbuilder.load_model(str(out), device="cpu")
    if item == "torchrun":
        assert not torch.distributed.is_initialized()
        assert _info(out)["backend"] == "gloo"
        assert _info(out)["mesh"] == dict(data=1, fsdp=1, expert=1, tensor=1,
                                          pipe=1)
    if margs.get("lora_enable"):
        adapter = torch.load(out / "adapter" / "adapter_model.bin",
                             weights_only=True)
        assert len(adapter) == 2 * 3 * cfg.llm.num_layers  # FFN only
        before, after = _state(dirs["port"]), _state(out)
        moved = {k for k in before if not torch.equal(before[k], after[k])}
        assert {f"llm.layers.{i}.mlp.{w}" for i in range(cfg.llm.num_layers)
                for w in ("gate", "up", "down")} <= moved
        assert not any(k.startswith("vision.") for k in moved)
    elif item == "runs":
        assert not cfg.llm.seq_shard_activations
    elif item == "torchrun":        # the fused step: 2 folded updates
        assert _info(out)["microbatches"] == 4
        before, after = _state(dirs["port"]), _state(out)
        assert any(not torch.equal(before[k], after[k]) for k in before
                   if k.startswith("llm.layers."))
    elif margs.get("s2"):
        assert cfg.s2_scales == (28, 56) and cfg.vision_feature_dim == 64
        assert model.projector.layers[0].kernel.shape[0] == 64
    else:
        assert cfg.video_projector_type == "linear" and cfg.video_global_proj
        assert hasattr(model, "video_projector")
        with pytest.raises(ValueError, match="video"):
            trun.run_stage("align", ModelArgs(**margs), DataArgs(
                data_path=[dirs["sft"]], image_folder=dirs["imgs"]),
                _targs(tmp_path / "x", **targs), salign=salign,
                tokenizer=StubTok(), device="cpu")
