"""The port's eval CLI, single-query API and chat CLI on the CPU, in
process, against the JAX package's, from the same tiny checkpoint: JAX
`save_model` of a seeded MoE LLaVA in one directory, the port's
`save_model` of the same weights in another of the same name, and the tiny
char-level HF tokenizer in both.

`generate` (float and `--quant int8 --kv-cache-dtype int8`) gives the same
answer rows as JAX's but the random `answer_id`; `merge`, `convert` and
`score` write the same bytes; `run_llava.single_query` and the chat loop
give the same replies, streamed or not.  From an HF LLaVA directory (the
port's `export_hf_llava` of the same weights, the tokenizer files beside
them) with the tower of an HF CLIP directory (the port's `--vision-path`;
the JAX side through `load_pretrained_model(vision_path=...)`, which its
CLIs do not expose), `generate` and `run_llava.single_query` give JAX's
answers and the server's `build_engine` serves it; with no tower the load
raises a ValueError naming vision_path.  With `--model-base` the port's
`generate` answers from a LoRA adapter merged onto that base, as the
merged model tools.merge_lora writes does.  The JAX side decodes through its
XLA branch (LLAVAMOD_DECODE_ATTN=xla), which changes nothing in the JAX
package; both packages preprocess images on their C++ batch paths, which
give the same bits."""

import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image
from util_tokenizer import make_tiny_tokenizer
from util_torch_port import matched_llava, tiny_llava_config

from llavamod_tpu.eval import cli as jcli
from llavamod_tpu.eval import run_llava as jrun_llava
from llavamod_tpu.models.builder import save_model as jsave_model
from llavamod_tpu.serve import cli as jchat
from llavamod_tpu_torch.eval import cli as tcli
from llavamod_tpu_torch.eval import run_llava as trun_llava
from llavamod_tpu_torch.models.builder import save_model
from llavamod_tpu_torch.serve import cli as tchat

NEW = "4"


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_llava_config(moe_layers=(0, 1))
    jcfg, params, model = matched_llava(cfg, seed=5)
    jdir = jsave_model(str(root / "jax" / "ckpt"), jcfg, params)
    tdir = save_model(str(root / "torch" / "ckpt"), model)
    for d in (jdir, tdir):
        make_tiny_tokenizer(d)
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (48, 40, 3), dtype=np.uint8)
                        ).save(imgs / f"{i}.png")
    questions = [{"question_id": i, "text": f"Is there a cat {i}?",
                  "image": f"{i % 3}.png", "category": "random"}
                 for i in range(5)]
    qfile = root / "questions.jsonl"
    qfile.write_text("".join(json.dumps(q) + "\n" for q in questions))
    return dict(root=root, jax=jdir, torch=tdir, imgs=str(imgs),
                qfile=str(qfile), questions=questions)


@pytest.fixture
def jax_side(monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k != "answer_id"}
            for line in open(path)]


@pytest.mark.parametrize("extra", [[], ["--quant", "int8",
                                        "--kv-cache-dtype", "int8"]],
                         ids=["float", "int8"])
def test_generate_matches_jax(ckpts, jax_side, extra):
    root = ckpts["root"]
    tag = "int8" if extra else "float"
    argv = ["generate", "--question-file", ckpts["qfile"], "--image-folder",
            ckpts["imgs"], "--conv-mode", "qwen", "--batch-size", "2",
            "--max-new-tokens", NEW] + extra
    jcli.main(argv + ["--model-path", ckpts["jax"], "--answers-file",
                      str(root / f"j_{tag}.jsonl")])
    runner = tcli.main(argv + ["--model-path", ckpts["torch"],
                               "--answers-file", str(root / f"t_{tag}.jsonl")],
                       device="cpu")
    got, want = _rows(root / f"t_{tag}.jsonl"), _rows(root / f"j_{tag}.jsonl")
    assert len(got) == 5 and got == want
    assert all(r["model_id"] == "ckpt" for r in got)
    assert runner.model.llm.final_norm.weight.device.type == "cpu"


def _answers(ckpts):
    """Answer rows in the reference schema, written as two chunk files."""
    rows = [{"question_id": q["question_id"], "prompt": q["text"],
             "text": ["Yes", "no, there is not", "yes.", "No", "maybe"][i],
             "answer_id": f"id{i}", "model_id": "ckpt", "metadata": {}}
            for i, q in enumerate(ckpts["questions"])]
    paths = []
    for c, part in enumerate((rows[:3], rows[3:])):
        p = ckpts["root"] / f"chunk{c}.jsonl"
        p.write_text("".join(json.dumps(r) + "\n" for r in part))
        paths.append(str(p))
    return paths


def _host_argvs(ckpts):
    """{name: argv without --output} for merge, convert and score."""
    root = ckpts["root"]
    chunks = _answers(ckpts)
    merged = str(root / "merged.jsonl")
    tcli.main(["merge", "--inputs", *chunks, "--output", merged])
    ann = root / "pope_ann"
    ann.mkdir(exist_ok=True)
    (ann / "coco_pope_random.json").write_text("".join(
        json.dumps({"question_id": q["question_id"],
                    "label": "yes" if q["question_id"] % 2 else "no"}) + "\n"
        for q in ckpts["questions"]))
    test_qs = root / "test_qs.jsonl"
    test_qs.write_text("".join(json.dumps({"question_id": q["question_id"],
                                           "image": f"{q['question_id']}.jpg"})
                               + "\n" for q in ckpts["questions"]))
    gqa_q = root / "gqa_q.json"
    gqa_q.write_text(json.dumps({str(q["question_id"]): {
        "answer": ["yes", "no"][q["question_id"] % 2], "types": {
            "structural": "verify", "semantic": "attr", "detailed": "x"},
        "groups": {"global": None, "local": "g"}, "imageId": "img"}
        for q in ckpts["questions"]}))
    gqa_pred = root / "gqa_pred.json"
    gqa_pred.write_text(json.dumps([{"questionId": str(i), "prediction": p}
                                    for i, p in enumerate(
                                        ["yes", "no", "no", "no", "yes"])]))
    mme_q = root / "mme_q.jsonl"
    mme_q.write_text("".join(json.dumps({
        "question_id": q["question_id"], "image": f"{q['question_id'] // 2}.jpg",
        "category": "OCR", "text": q["text"],
        "answer": ["Yes", "No"][q["question_id"] % 2]}) + "\n"
        for q in ckpts["questions"]))
    return {
        "merge": ["merge", "--inputs", *chunks],
        "convert_gqa": ["convert", "--benchmark", "gqa", "--answers", merged],
        "convert_vqav2": ["convert", "--benchmark", "vqav2", "--answers",
                          merged, "--test-questions", str(test_qs)],
        "convert_vizwiz": ["convert", "--benchmark", "vizwiz", "--answers",
                           merged, "--test-questions", str(test_qs)],
        "convert_mmvet": ["convert", "--benchmark", "mmvet", "--answers",
                          merged],
        "score_pope": ["score", "--benchmark", "pope", "--question-file",
                       ckpts["qfile"], "--answers", merged,
                       "--annotation-dir", str(ann)],
        "score_gqa": ["score", "--benchmark", "gqa", "--question-file",
                      str(gqa_q), "--answers", str(gqa_pred)],
        "score_mme": ["score", "--benchmark", "mme", "--answers", merged,
                      "--question-file", str(mme_q)],
    }


@pytest.mark.parametrize("name", ["merge", "convert_gqa", "convert_vqav2",
                                  "convert_vizwiz", "convert_mmvet",
                                  "score_pope", "score_gqa", "score_mme"])
def test_host_commands_write_jax_bytes(ckpts, name, capsys):
    argv = _host_argvs(ckpts)[name]
    capsys.readouterr()
    root = ckpts["root"]
    jout, tout = str(root / f"{name}_j.out"), str(root / f"{name}_t.out")
    jcli.main(argv + ["--output", jout])
    jprinted = capsys.readouterr().out.replace(jout, "OUT")
    tcli.main(argv + ["--output", tout])
    tprinted = capsys.readouterr().out.replace(tout, "OUT")
    assert open(tout, "rb").read() == open(jout, "rb").read()
    assert tprinted == jprinted
    if name == "score_pope":
        counts = json.load(open(tout))["random"]
        assert sum(counts[k] for k in ("TP", "FP", "TN", "FN")) == 5


def test_baseline_echo_matches_jax(ckpts, tmp_path):
    argv = ["baseline", "--question-file", ckpts["qfile"], "--transport",
            "echo", "--max-workers", "2"]
    jcli.main(argv + ["--output", str(tmp_path / "j.jsonl")])
    tcli.main(argv + ["--output", str(tmp_path / "t.jsonl")])
    assert _rows(tmp_path / "t.jsonl") == _rows(tmp_path / "j.jsonl")


def test_single_query_matches_jax(ckpts, jax_side):
    image = os.path.join(ckpts["imgs"], "1.png")
    want = jrun_llava.single_query(ckpts["jax"], image, "What is it?",
                                   conv_mode="qwen", max_new_tokens=6)
    runner = trun_llava.load_runner(ckpts["torch"], conv_mode="qwen",
                                    device="cpu")
    got = trun_llava.single_query(ckpts["torch"], image, "What is it?",
                                  conv_mode="qwen", max_new_tokens=6,
                                  runner=runner)
    assert got == want
    assert trun_llava.single_query(ckpts["torch"], image, "What is it?",
                                   conv_mode="qwen", max_new_tokens=6,
                                   device="cpu") == want


def test_chat_cli_stream_and_no_stream_match_jax(ckpts, jax_side,
                                                 monkeypatch, capsys):
    turns = "Describe the image.\nAnd the colours?\n\n"
    argv = ["--image-file", os.path.join(ckpts["imgs"], "2.png"),
            "--conv-mode", "qwen", "--max-new-tokens", "6", "--temperature",
            "0", "--stream-chunk", "0"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
    monkeypatch.setattr(sys, "argv", ["cli", "--model-path", ckpts["jax"]]
                        + argv)
    jchat.main()
    jprinted = capsys.readouterr().out
    replies = {}
    for chunk in ("0", "2"):
        monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
        replies[chunk] = tchat.main(["--model-path", ckpts["torch"]]
                                    + argv[:-1] + [chunk], device="cpu")
        printed = capsys.readouterr().out
        if chunk == "0":   # the same transcript as the JAX CLI's
            assert printed == jprinted
    assert len(replies["0"]) == 2 and replies["0"] == replies["2"]
    assert f"ASSISTANT: {replies['0'][0]}\n" in jprinted


def test_chat_cli_int8_runs(ckpts, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("Hello?\n"))
    replies = tchat.main(["--model-path", ckpts["torch"], "--image-file",
                          os.path.join(ckpts["imgs"], "0.png"), "--conv-mode",
                          "qwen", "--max-new-tokens", "3", "--temperature",
                          "0", "--quant", "int8", "--kv-cache-dtype", "int8"],
                         device="cpu")
    assert len(replies) == 1 and isinstance(replies[0], str)


@pytest.mark.parametrize("case,item", [("model_base", 6)])
def test_unported_loads_raise(ckpts, tmp_path, case, item):
    """Once refused as ROADMAP item 6: `--model-base` merges a LoRA adapter
    directory onto the base the flag names (the tokenizer comes from the
    base); the answers equal, row for row, those of the merged model that
    tools.merge_lora writes."""
    import torch

    from llavamod_tpu_torch.models import builder as tbuilder
    from llavamod_tpu_torch.models import lora as tlora
    from llavamod_tpu_torch.tools import merge_lora

    _, base = tbuilder.load_model(ckpts["torch"], device="cpu")
    lcfg = tlora.LoraConfig(r=4, alpha=8, target_patterns=tlora.FFN_TARGETS)
    lora = tlora.init_lora(base, lcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in lora.parameters():
            p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(2))
    adapter = tlora.save_lora_adapter(str(tmp_path / "adapter"), lora, lcfg)
    merged = merge_lora.main(["--model-path", adapter, "--model-base",
                              ckpts["torch"], "--save-path",
                              str(tmp_path / "merged"), "--device", "cpu"])
    make_tiny_tokenizer(merged)
    argv = ["generate", "--question-file", ckpts["qfile"], "--image-folder",
            ckpts["imgs"], "--conv-mode", "qwen", "--batch-size", "2",
            "--max-new-tokens", NEW]
    tcli.main(argv + ["--model-path", adapter, "--model-base", ckpts["torch"],
                      "--answers-file", str(tmp_path / "a.jsonl")],
              device="cpu")
    tcli.main(argv + ["--model-path", merged, "--answers-file",
                      str(tmp_path / "m.jsonl")], device="cpu")

    def rows(name):
        return [{k: v for k, v in r.items() if k != "model_id"}
                for r in _rows(tmp_path / name)]

    assert len(rows("a.jsonl")) == 5 and rows("a.jsonl") == rows("m.jsonl")
    up = "llm.layers.1.mlp.experts.up"
    assert not torch.equal(tbuilder.load_model(merged, device="cpu")[1]
                           .state_dict()[up], base.state_dict()[up])


@pytest.fixture(scope="module")
def hf_ckpt(ckpts):
    """The port's checkpoint as an HF LLaVA directory (named 'ckpt' too, so
    both CLIs write the same model_id; its config names the tiny tower,
    registered here) and a tiny HF CLIP tower directory (its name selects
    the registered tiny CLIP config without the patch bias that HF CLIP
    lacks)."""
    import torch
    import transformers

    from llavamod_tpu.models.vision import vit as jvit
    from llavamod_tpu_torch.interop.hf import export_hf_llava
    from llavamod_tpu_torch.models.builder import load_model
    from llavamod_tpu_torch.models.vision import vit as tvit

    for registry, make in ((tvit.vision_configs, tvit.tiny_vision_config),
                           (jvit.vision_configs, jvit.tiny_vision_config)):
        if "tiny-vit" not in registry:
            registry.register("tiny-vit", make())
        if "tiny-clip" not in registry:
            registry.register("tiny-clip", make(name="tiny-clip",
                                                patch_bias=False))
    cfg, model = load_model(ckpts["torch"], device="cpu")
    hf_dir = export_hf_llava(str(ckpts["root"] / "hf" / "ckpt"), cfg,
                             model.state_dict())
    make_tiny_tokenizer(hf_dir)
    torch.manual_seed(7)
    tower = str(ckpts["root"] / "tiny-clip")
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=14)
    ).save_pretrained(tower)
    return hf_dir, tower


@pytest.fixture
def jax_hf_tower(hf_ckpt, monkeypatch):
    """The JAX loader handed the tower directory (its CLIs take none)."""
    import functools

    from llavamod_tpu.models import builder as jbuilder

    monkeypatch.setattr(jbuilder, "load_pretrained_model", functools.partial(
        jbuilder.load_pretrained_model, vision_path=hf_ckpt[1]))


def test_generate_from_an_hf_directory_matches_jax(ckpts, hf_ckpt, jax_side,
                                                   jax_hf_tower):
    hf_dir, tower = hf_ckpt
    root = ckpts["root"]
    argv = ["generate", "--question-file", ckpts["qfile"], "--image-folder",
            ckpts["imgs"], "--conv-mode", "qwen", "--batch-size", "2",
            "--max-new-tokens", NEW, "--model-path", hf_dir]
    jcli.main(argv + ["--answers-file", str(root / "j_hf.jsonl")])
    runner = tcli.main(argv + ["--answers-file", str(root / "t_hf.jsonl"),
                               "--vision-path", tower], device="cpu")
    got, want = _rows(root / "t_hf.jsonl"), _rows(root / "j_hf.jsonl")
    assert len(got) == 5 and got == want
    assert runner.cfg.vision.name == "tiny-clip"


def test_single_query_and_server_from_an_hf_directory(ckpts, hf_ckpt,
                                                      jax_side, jax_hf_tower):
    from llavamod_tpu_torch.serve.server import build_engine

    hf_dir, tower = hf_ckpt
    image = os.path.join(ckpts["imgs"], "1.png")
    kw = dict(conv_mode="qwen", max_new_tokens=int(NEW))
    want = jrun_llava.single_query(hf_dir, image, "What is it?", **kw)
    got = trun_llava.single_query(hf_dir, image, "What is it?", **kw,
                                  device="cpu", vision_path=tower)
    assert got == want
    engine = build_engine(hf_dir, device="cpu", vision_path=tower,
                          max_prompt_len=48, default_max_new=3,
                          batch_window=0.01)
    try:
        out = engine.submit(engine.runner.build_prompt("hello", False), None,
                            3)
        assert out["usage"]["completion_tokens"] <= 3
        assert engine.runner.cfg.vision.name == "tiny-clip"
    finally:
        engine.shutdown()


def test_hf_directory_without_a_tower_raises(ckpts, hf_ckpt, tmp_path):
    argv = ["generate", "--question-file", ckpts["qfile"], "--answers-file",
            str(tmp_path / "a.jsonl"), "--model-path", hf_ckpt[0]]
    with pytest.raises(ValueError, match="vision_path"):
        tcli.main(argv, device="cpu")
