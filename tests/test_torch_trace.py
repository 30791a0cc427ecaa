"""The port's span recorder (llavamod_tpu_torch/runtime/trace.py) on the
CPU: off it is a shared no-op that reads no clock; on, spans nest with
their parent, id and attributes; and the spans at the layer boundaries
(the engine, generation, the training step, the prefetcher) come out as
many and as nested as each layer's work."""

import threading
import time
import types

import numpy as np
import pytest
import torch

from llavamod_tpu_torch import generation as tgen
from llavamod_tpu_torch.eval.generate import VQARunner
from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.builder import make_image_preprocessor
from llavamod_tpu_torch.models.llava import LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.vision.vit import tiny_vision_config
from llavamod_tpu_torch.runtime import trace
from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
from llavamod_tpu_torch.serve.server import BatchingEngine
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

torch.set_num_threads(2)

VOCAB, T = 300, 24
PHASES = ("train.student_fwd", "train.teacher_fwd", "train.loss",
          "train.backward", "train.update")


@pytest.fixture
def on():
    """The recorder on for one test, off and empty after it."""
    trace.collect()
    trace.enable()
    yield
    trace.disable()
    trace.collect()


def _cfg():
    return LlavaConfig(llm=tiny_config(vocab_size=VOCAB, moe_num_experts=4,
                                       moe_layers=(0,)),
                       vision=tiny_vision_config(),
                       projector_type="mlp2x_gelu", max_images=1)


class CharTok:
    pad_token_id, eos_token_id = 0, None

    def __call__(self, text):
        return types.SimpleNamespace(
            input_ids=[(ord(c) % 200) + 5 for c in text[-24:]])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + (int(i) % 26)) for i in ids)


def _names(records):
    return [r["name"] for r in records]


def test_off_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("the clock was read")

    trace.collect()
    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    first = trace.span("a", device=True, rows=3)
    with first as sp, trace.span("b") as inner:
        sp.set(x=1)
        assert trace.stamp() == 0
        trace.record("c", 5)
    assert first is inner is sp
    assert trace.collect() == []


def test_nested_spans_carry_parent_id_and_attributes(on):
    with trace.span("outer", id=7, rows=2) as outer:
        with trace.span("inner", device=True) as inner:
            inner.set(applied=True)
        with trace.span("other", id="x"):
            trace.record("wait", time.time_ns() - 1000)
    got = {r["name"]: r for r in trace.collect()}
    assert set(got) == {"outer", "inner", "other", "wait"}
    assert got["outer"]["parent"] is None and got["outer"]["id"] == 7
    assert got["outer"]["attrs"] == {"rows": 2}
    assert got["inner"]["parent"] == got["outer"]["sid"]
    assert got["inner"]["id"] == 7                     # the parent's
    assert got["inner"]["attrs"] == {"applied": True}
    assert got["inner"]["device_ms"] is None           # no CUDA here
    assert got["other"]["id"] == "x"
    assert got["wait"]["parent"] == got["other"]["sid"]
    assert got["wait"]["thread"] is None and got["wait"]["cpu_ns"] is None
    for r in got.values():
        assert r["start_ns"] <= r["end_ns"]
    assert got["outer"]["start_ns"] <= got["inner"]["start_ns"]
    assert got["inner"]["end_ns"] <= got["outer"]["end_ns"]
    assert got["outer"]["thread"] == threading.get_ident()
    assert trace.collect() == []                       # cleared


def test_thread_cpu_time_shows_a_wait():
    trace.collect()
    trace.enable()
    try:
        with trace.span("sleep"):
            time.sleep(0.05)
    finally:
        trace.disable()
    r, = trace.collect()
    wall = r["end_ns"] - r["start_ns"]
    assert wall >= 0.05e9 and r["cpu_ns"] < 0.5 * wall


def test_a_running_profiler_records_spans_and_shows_them():
    from torch.profiler import ProfilerActivity, profile

    trace.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.outer"):
            torch.ones(8).sum()
    with trace.span("after"):
        pass
    assert _names(trace.collect()) == ["probe.outer"]
    assert "probe.outer" in {e.key for e in prof.key_averages()}


def test_engine_spans_per_request_and_per_batch(on):
    cfg = _cfg()
    model = llava.init(cfg, torch.Generator().manual_seed(0))
    runner = VQARunner(model=model, tokenizer=CharTok(),
                       image_preprocessor=make_image_preprocessor(cfg),
                       template_name="qwen", max_prompt_len=48)
    engine = BatchingEngine(runner, max_batch=2, batch_window=0.5,
                            default_max_new=2)
    img = np.zeros((1, 3, cfg.vision.image_size, cfg.vision.image_size),
                   np.float32)
    outs = []

    def ask(i):
        outs.append(engine.submit(runner.build_prompt(f"q{i}", True), img,
                                  2, timeout=120))

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(150)
        assert not any(th.is_alive() for th in threads) and len(outs) == 3
    finally:
        engine.shutdown()
    recs = trace.collect()
    queue = [r for r in recs if r["name"] == "serve.queue"]
    fanouts = [r for r in recs if r["name"] == "serve.fanout"]
    prefills = sorted((r for r in recs if r["name"] == "generate.prefill"),
                      key=lambda r: r["start_ns"])
    assert sorted(r["id"] for r in queue) == sorted(o["id"] for o in outs)
    assert all(r["thread"] is None and r["parent"] is None for r in queue)
    n_batches = engine.stats_snapshot()["batches"]
    assert n_batches >= 2
    assert len(fanouts) == len(prefills) == n_batches
    # one engine thread; each batch's fan-out after its prefill
    assert len({r["thread"] for r in fanouts + prefills}) == 1
    for p, f in zip(prefills, sorted(fanouts, key=lambda r: r["start_ns"])):
        assert p["end_ns"] <= f["start_ns"]
    # each request waits from its put until its batch starts, before the
    # batch's prefill: every batch takes at least one request
    taken = [sum(1 for q in queue if q["end_ns"] <= p["start_ns"])
             for p in prefills]
    assert taken == sorted(taken) and taken[-1] == 3
    assert all(a < b for a, b in zip([0] + taken, taken))
    for q in queue:
        assert q["start_ns"] <= q["end_ns"]


@pytest.mark.parametrize("n", [1, 4])
def test_generate_spans_one_prefill_and_n_minus_one_steps(on, n):
    cfg = _cfg()
    model = llava.init(cfg, torch.Generator().manual_seed(1))
    b, t, s = 2, 20, cfg.vision.image_size
    ids = torch.randint(5, VOCAB, (b, t), dtype=torch.int32)
    seg = torch.ones((b, t), dtype=torch.int32)
    seg[1, :4] = 0
    im = torch.zeros((b, t), dtype=torch.bool)
    batch = MultimodalBatch(
        input_ids=ids, segment_ids=seg, image_mask=im,
        image_pos=torch.zeros((b, t), dtype=torch.int32),
        pixels=torch.zeros((b, 1, 3, s, s)),
        pixel_valid=torch.zeros((b, 1), dtype=torch.bool), labels=None)
    out = tgen.generate(model, batch,
                        tgen.GenerationConfig(max_new_tokens=n))
    assert out.shape == (b, n)
    names = _names(trace.collect())
    assert names.count("generate.prefill") == 1
    assert names.count("generate.decode_step") == n - 1
    assert len(names) == n


def _align_batch(cfg, seed):
    rng = np.random.RandomState(seed)
    b, n_img, s = 2, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, VOCAB, (b, T)).astype(np.int32)
    seg = np.ones((b, T), np.int32)
    im = np.zeros((b, T), bool)
    ip = np.zeros((b, T), np.int32)
    for i in range(b):
        im[i, 1:1 + n_img] = True
        ip[i, 1:1 + n_img] = i * n_img + np.arange(n_img)
    labels = np.where(im, -100, ids)
    return {"input_ids": ids, "segment_ids": seg, "image_mask": im,
            "image_pos": ip,
            "pixels": rng.randn(b, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((b, 1), bool), "labels": labels}


def test_align_microbatches_give_the_step_phases(on):
    student = _cfg()
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", moe_num_experts=0, moe_layers=()))
    model = llava.init(student, torch.Generator().manual_seed(0))
    tmodel = llava.init(teacher, torch.Generator().manual_seed(7),
                        vision=False)
    tcfg = TrainConfig(stage="align", align_loss_type="kd_lm",
                       compute_dtype="float32", vocab_chunk=96,
                       learning_rate=1e-3, warmup_ratio=0.0,
                       grad_accum_steps=2)
    state = TrainState.create(model, tcfg)
    step = make_align_step(student, teacher, tcfg)
    applied = []
    for i in range(2):
        state, _ = step(state, tmodel,
                        batch_from_arrays(_align_batch(student, i),
                                          device="cpu"))
        recs = trace.collect()
        top, = [r for r in recs if r["name"] == "train.step"]
        assert top["id"] == i and top["parent"] is None
        kids = {r["name"]: r for r in recs if r["parent"] == top["sid"]}
        assert sorted(kids) == sorted(PHASES)
        assert len(recs) == 1 + len(PHASES)
        assert all(r["id"] == i for r in recs)
        starts = [kids[p]["start_ns"] for p in PHASES]
        assert starts == sorted(starts)
        applied.append(kids["train.update"]["attrs"]["applied"])
    assert applied == [False, True]
    assert state.opt.updates == 1


def test_prefetcher_spans_per_batch(on):
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    got = []
    for b in DevicePrefetcher(iter(batches), device="cpu", depth=2):
        got.append(float(b["x"][0, 0]))
    assert got == [0.0, 1.0, 2.0]
    recs = trace.collect()
    nexts = {r["sid"]: r for r in recs if r["name"] == "data.next"}
    # the first fill, then one step per batch
    assert len(nexts) == 1 + len(batches)
    waits = [r for r in recs if r["name"] == "data.wait"]
    sends = [r for r in recs if r["name"] == "data.send"]
    # each batch waited for and sent once; the two fills after the last
    # batch each meet the end of the loader
    assert len(sends) == len(batches) and len(waits) == len(batches) + 2
    assert all(r["parent"] in nexts for r in waits + sends)
