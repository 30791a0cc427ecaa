"""The plain reference (benchmark/reference) against the program at a tiny
size on the CPU: the same token ids and labels as the program's data path,
the same pixels as its C++ preprocessor, the same logits as its forward;
and whole runs of both drivers, whose comparison decides `correct`, come
out correct.  This file imports both; the reference imports nothing of
the program (test_bench_imports.py)."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import program, traffic
from benchmark.harness import weights as wmod
from benchmark.harness.tokenizer import StandInTokenizer
from benchmark.reference import checks as rchecks
from benchmark.reference import image as rimage
from benchmark.reference import model as rm
from benchmark.reference import text as rtext
from benchmark.tests import tiny

SEED = 2 ** 31 + 99


def test_token_ids_and_labels_are_the_programs(tmp_path):
    from llavamod_tpu_torch.data.collator import SupervisedCollator
    from llavamod_tpu_torch.data.dataset import SupervisedJsonDataset
    from llavamod_tpu_torch.mm_utils import ImagePreprocessor

    tok = StandInTokenizer()
    mix = tiny.CONVERSATIONS
    data, folder, records, _ = traffic.write_conversations(
        mix, SEED, tok, wmod.n_image(tiny.STUDENT), str(tmp_path))
    ds = SupervisedJsonDataset(data, tok, ImagePreprocessor(size=28),
                               image_folder=folder, template_name="qwen",
                               model_max_length=384)
    coll = SupervisedCollator(max_len=384, num_image_tokens=4, image_size=28,
                              max_images=1, pad_id=0)
    for i, rec in enumerate(records):
        b = coll([ds[i]])
        ids, labels = rtext.conversation_ids(rec["conversations"], tok)
        ids, labels, start = rtext.splice(ids, labels, 4, 384)
        n = len(ids)
        assert b["input_ids"][0, :n].tolist() == ids
        assert b["labels"][0, :n].tolist() == labels
        assert b["image_mask"][0, start:start + 4].all()
        assert (b["segment_ids"][0, n:] == 0).all()


def test_pixels_are_the_programs_cpp_preprocessor():
    from PIL import Image

    from llavamod_tpu_torch.mm_utils import ImagePreprocessor

    for img in traffic.images(tiny.QUESTIONS, SEED) + traffic.images(
            {"images": 2, "image_sizes": [[640, 480], [427, 640]]}, SEED):
        prog = ImagePreprocessor(size=336, image_aspect_ratio="pad")(
            [Image.fromarray(img)])[0]
        np.testing.assert_allclose(rimage.preprocess(img, 336).numpy(), prog,
                                   atol=2e-5)


def test_logits_are_the_programs_forward():
    """One image question through the program's runner batch and forward
    in float32 against the reference's forward."""
    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.builder import make_image_preprocessor

    cfg = tiny.STUDENT
    tok = StandInTokenizer()
    pcfg, model = program.build(cfg, SEED, "model", "cpu", torch.float32)
    runner = VQARunner(model=model, tokenizer=tok,
                       image_preprocessor=make_image_preprocessor(pcfg),
                       max_prompt_len=320)
    img = traffic.images(tiny.QUESTIONS, SEED)[0]
    q = "what is in the picture?"
    from PIL import Image

    batch = runner._encode_batch([runner.build_prompt(q, True)],
                                 [runner.image_preprocessor(Image.fromarray(img))])
    with torch.no_grad():
        seg = batch.segment_ids
        pos = torch.clamp_min(torch.cumsum(seg, 1) - 1, 0)
        out = llava.forward(model, pcfg, batch._replace(positions=pos))
        got = llava.logits(model, pcfg, out.hidden)[0, -1]
        W = wmod.make_state(cfg, SEED, "model", "cpu", torch.float32)
        want, _ = rchecks._request_logits(W, cfg, rm.Linear(W, rm.Numerics()),
                                          rm.Numerics(), img, q, [1], tok, "cpu")
    want = want[0]
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


def test_moe_gating_keeps_the_capacity_and_queues_choice_two_last():
    logits = torch.tensor([[3.0, 2.0, 0.0], [3.0, 0.0, 2.0], [3.0, 2.0, 0.0]])
    routes, aux = rm.arch(tiny.STUDENT).moe_gating(logits, k=2, capacity=2)
    (e1, w1), (e2, w2) = routes
    assert e1.tolist() == [0, 0, 0] and e2.tolist() == [1, 2, 1]
    # expert 0 holds two: the third token's first choice is dropped and
    # its second choice takes the whole weight
    assert (w1[:2] > 0).all() and w1[2] == 0
    assert torch.isclose(w2[2], torch.tensor(1.0))
    assert aux > 0


@pytest.mark.parametrize("driver", ["distill", "serve"])
def test_a_sound_run_is_correct(driver):
    from benchmark.drivers import distill, serve

    torch.manual_seed(0)
    with tiny.tiny_files():
        if driver == "distill":
            out = distill.run("t", tiny.DISTILL, SEED, 1.0, False, "cpu",
                              time.perf_counter(), log=lambda *a: None)
        else:
            out = serve.run("t", tiny.SERVE, SEED, 1.0, False, "cpu",
                            time.perf_counter(), log=lambda *a: None)
    assert out["checks"] and all(c["ok"] for c in out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
