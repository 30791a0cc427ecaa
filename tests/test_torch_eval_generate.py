"""Batched eval generation on the CPU: the port's `VQARunner.run` answers a
question file as the JAX package's does, from the same weights, in f32:
the same answer rows (all but the random `answer_id`), hence the same
generated ids, and the same router-probability dump.  The JAX side decodes
through its XLA branch (LLAVAMOD_DECODE_ATTN=xla), as in
test_torch_generation.py.  Both runners get the port's image preprocessor:
the JAX package resizes through its optional C++ batch path, which the
port does not carry (its PIL path is the one the port copies), and the
pixels would differ by ~1e-2."""

import json
import types

import numpy as np
import pytest
from PIL import Image
from util_torch_port import matched_llava, tiny_llava_config

from llavamod_tpu.eval import generate as jeval
from llavamod_tpu.generation import GenerationConfig as JGenerationConfig
from llavamod_tpu_torch.eval import generate as teval
from llavamod_tpu_torch.generation import GenerationConfig
from llavamod_tpu_torch.models.builder import make_image_preprocessor

NEW = 5
# router probabilities, port vs JAX, both f32: |a - b| <= 1e-5 + 1e-5 |b|
# (f32 rounding through the tower and two decoder layers)
GATING_TOL = 1e-5


class CharTok:
    """One id per character of the last 24 characters of a text (ids within
    the tiny vocab), decoded back to letters."""
    pad_token_id = 0
    eos_token_id = None

    def __call__(self, text):
        return types.SimpleNamespace(
            input_ids=[(ord(c) % 200) + 5 for c in text[-24:]])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + (int(i) % 26)) for i in ids)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = tiny_llava_config(moe_layers=(0, 1))
    jcfg, params, model = matched_llava(cfg, seed=11)
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (40, 30, 3), dtype=np.uint8)
                        ).save(root / f"{i}.png")
    questions = [{"question_id": f"q{i}", "text": f"what is shown {i}?",
                  **({"image": f"{i % 3}.png"} if i != 3 else {})}
                 for i in range(5)]
    return cfg, jcfg, params, model, root, questions


def _runners(setup, tag, cache_dtype="float32"):
    cfg, jcfg, params, model, root, _ = setup
    kw = dict(template_name="qwen", batch_size=2, max_prompt_len=64,
              model_id="tiny", dump_gating=str(root / f"{tag}_gating.npz"))
    jr = jeval.VQARunner(params, jcfg, CharTok(), make_image_preprocessor(cfg),
                         **{**kw, "dump_gating": str(root / f"{tag}_j.npz")})
    tr = teval.VQARunner(model, CharTok(), make_image_preprocessor(cfg),
                         **{**kw, "dump_gating": str(root / f"{tag}_t.npz")})
    eos, stops = tr.stopping(())
    assert (eos, stops) == jr.stopping(())
    gkw = dict(max_new_tokens=NEW, eos_token_ids=eos, stop_sequences=stops,
               pad_token_id=0, cache_dtype=cache_dtype)
    return jr, tr, JGenerationConfig(**gkw), GenerationConfig(**gkw)


def _no_answer_id(rows):
    return [{k: v for k, v in r.items() if k != "answer_id"} for r in rows]


def test_run_matches_jax_rows_and_gating(setup, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg, _, _, _, root, questions = setup
    jr, tr, jg, tg = _runners(setup, "f32")
    want = jr.run(questions, str(root), str(root / "j.jsonl"), jg)
    got = tr.run(questions, str(root), str(root / "t.jsonl"), tg)
    assert len(got) == 5 and [r["question_id"] for r in got] == [
        q["question_id"] for q in questions]
    assert set(got[0]) == {"question_id", "prompt", "text", "answer_id",
                           "model_id", "metadata"}
    assert _no_answer_id(got) == _no_answer_id(want)
    assert any(r["text"] for r in got)
    on_disk = [json.loads(line) for line in open(root / "t.jsonl")]
    assert _no_answer_id(on_disk) == _no_answer_id(got)

    jz, tz = np.load(root / "f32_j.npz"), np.load(root / "f32_t.npz")
    assert sorted(tz.files) == sorted(jz.files) == sorted(
        q["question_id"] for q in questions)
    for k in tz.files:
        assert tz[k].shape == (2, 64, 4) and tz[k].dtype == np.float32
        np.testing.assert_allclose(tz[k], jz[k], atol=GATING_TOL,
                                   rtol=GATING_TOL)
        np.testing.assert_allclose(tz[k].sum(-1), 1.0, atol=1e-5)
    # the host time of batch building is counted per part
    assert tr.timings["image"] > 0 and tr.timings["encode"] > 0


def test_int8_cache_first_token_matches_jax(setup, monkeypatch):
    """With an int8 KV cache the first generated token (prefill, which reads
    no cache) equals the JAX int8-cache run's; the rows have the schema."""
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    _, _, _, _, root, questions = setup
    jr, tr, jg, tg = _runners(setup, "int8", cache_dtype="int8")
    jr.dump_gating = tr.dump_gating = None
    want = jr.run(questions, str(root), str(root / "j8.jsonl"), jg)
    got = tr.run(questions, str(root), str(root / "t8.jsonl"), tg)
    assert [r["question_id"] for r in got] == [r["question_id"] for r in want]
    assert [r["text"][:1] for r in got] == [r["text"][:1] for r in want]


@pytest.mark.parametrize("n,chunks", [(7, 3), (5, 2), (2, 4), (1, 3)])
def test_split_chunk_matches_jax(n, chunks):
    items = list(range(n))
    for idx in range(chunks):
        assert (teval.split_chunk(items, chunks, idx)
                == jeval.split_chunk(items, chunks, idx))


@pytest.mark.parametrize("template,extra", [("qwen", ()), ("qwen", ("###",)),
                                            ("vicuna_v1", ()),
                                            ("plain", ("\n",))])
def test_stopping_and_prompt_match_jax(setup, template, extra):
    cfg, jcfg, params, model, _, _ = setup
    jr = jeval.VQARunner(params, jcfg, CharTok(), make_image_preprocessor(cfg),
                         template_name=template, extra_prompt=" Answer:")
    tr = teval.VQARunner(model, CharTok(), make_image_preprocessor(cfg),
                         template_name=template, extra_prompt=" Answer:")
    assert tr.stopping(extra) == jr.stopping(extra)
    for has_image in (True, False):
        assert (tr.build_prompt("what?", has_image)
                == jr.build_prompt("what?", has_image))


def test_load_questions_and_main_on_cpu(setup, tmp_path):
    """`main` answers a question file from a saved checkpoint on the device
    asked for, with an injected tokenizer."""
    from llavamod_tpu_torch.models.builder import save_model

    cfg, _, _, model, root, questions = setup
    ckpt = save_model(str(tmp_path / "ckpt"), model)
    qfile = tmp_path / "q.jsonl"
    qfile.write_text("".join(json.dumps(q) + "\n" for q in questions[:3]))
    assert teval.load_questions(str(qfile)) == questions[:3]
    (tmp_path / "q.json").write_text(json.dumps(questions[:3]))
    assert teval.load_questions(str(tmp_path / "q.json")) == questions[:3]
    rows = teval.main(["--model-path", ckpt, "--question-file", str(qfile),
                       "--image-folder", str(root), "--answers-file",
                       str(tmp_path / "a.jsonl"), "--conv-mode", "qwen",
                       "--batch-size", "2", "--max-new-tokens", "3",
                       "--num-chunks", "2", "--chunk-idx", "0"],
                      tokenizer=CharTok(), device="cpu")
    assert [r["question_id"] for r in rows] == ["q0", "q1"]
    assert all(r["model_id"] == "ckpt" for r in rows)

