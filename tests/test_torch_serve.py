"""The port's dynamic-batching HTTP server on the CPU: a live
ThreadingHTTPServer + BatchingEngine over a tiny model.  Concurrent requests
come back correct and batched, padded rows do not leak into other requests,
streamed deltas concatenate to the final text, and a native checkpoint
directory serves through build_engine."""

import base64
import io
import json
import socket
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from llavamod_tpu_torch.eval.generate import VQARunner
from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.builder import make_image_preprocessor
from llavamod_tpu_torch.models.llava import LlavaConfig
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.vision.vit import tiny_vision_config
from llavamod_tpu_torch.serve.server import BatchingEngine, _bucket, make_handler

torch.set_num_threads(2)


class CharTok:
    pad_token_id = 0
    eos_token_id = None

    def __call__(self, text):
        return types.SimpleNamespace(
            input_ids=[(ord(c) % 200) + 5 for c in text[-24:]])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + (int(i) % 26)) for i in ids)


def _cfg():
    return LlavaConfig(llm=tiny_config(moe_num_experts=4, moe_layers=(0,)),
                       vision=tiny_vision_config(),
                       projector_type="mlp2x_gelu", max_images=1)


def _serve(engine):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", port),
                                 make_handler(engine, "tiny"))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    model = llava.init(cfg, torch.Generator().manual_seed(0))
    runner = VQARunner(model=model, tokenizer=CharTok(),
                       image_preprocessor=make_image_preprocessor(cfg),
                       template_name="qwen", max_prompt_len=64)
    engine = BatchingEngine(runner, max_batch=4, batch_window=0.5,
                            default_max_new=6, stream_chunk=2)
    server, url = _serve(engine)
    yield engine, runner, url
    server.shutdown()
    server.server_close()
    engine.shutdown()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        ctype = resp.headers["Content-Type"]
        body = resp.read().decode()
    if ctype == "text/event-stream":
        frames = [f.strip() for f in body.split("\n\n") if f.strip()]
        return frames
    return json.loads(body)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return json.loads(resp.read())


def test_health_stats_and_bad_request(served):
    engine, runner, url = served
    assert _get(url, "/health") == {"ok": True, "model": "tiny"}
    assert "bucket_hist" in _get(url, "/stats")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate", data=b'{"no_prompt": 1}'), timeout=30)
    assert e.value.code == 400


def test_concurrent_requests_are_batched_and_match_solo(served):
    engine, runner, url = served
    before = engine.stats["batches"]
    prompts = [f"what is item {i}?" for i in range(4)]
    results = [None] * 4

    def fire(i):
        results[i] = _post(url, {"prompt": prompts[i], "max_new_tokens": 6})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert all(r is not None for r in results)
    assert engine.stats["max_batch_seen"] >= 2
    for i, prompt in enumerate(prompts):
        solo = _post(url, {"prompt": prompt, "max_new_tokens": 6})
        assert solo["text"] == results[i]["text"]
        assert len(solo["text"]) == solo["usage"]["completion_tokens"] == 6
    assert engine.stats["batches"] > before


def test_image_request_and_stream(served):
    engine, runner, url = served
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 30, 3), dtype=np.uint8)).save(buf, format="PNG")
    payload = {"prompt": "describe", "image": base64.b64encode(
        buf.getvalue()).decode(), "max_new_tokens": 5}
    out = _post(url, payload)
    assert out["usage"]["prompt_tokens"] > runner.cfg.num_image_tokens
    frames = _post(url, {**payload, "stream": True})
    assert frames[-1] == "data: [DONE]"
    events = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    deltas = [e["delta"] for e in events if "delta" in e]
    final = [e for e in events if e.get("done")]
    assert len(final) == 1 and final[0]["text"] == out["text"]
    assert "".join(deltas).strip() == out["text"] and len(deltas) >= 2


class _EchoEngine(BatchingEngine):
    """The batcher without a model: counts the batch as `_run_batch` does
    and answers each request with its prompt."""

    def _run_batch(self, reqs):
        self._count_batch(len(reqs), _bucket(len(reqs), self.max_batch))
        for r in reqs:
            r.result = {"id": r.rid, "text": r.prompt}
            r.event.set()


def test_stats_are_exact_under_concurrent_submitters():
    engine = _EchoEngine(None, max_batch=4, batch_window=0.001)
    n_threads, per_thread = 8, 25
    answers = []

    def submitter(i):
        for j in range(per_thread):
            answers.append(engine.submit(f"{i}/{j}", None, 1)["text"])

    try:
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        snap = engine.stats_snapshot()
    finally:
        engine.shutdown()
    n = n_threads * per_thread
    assert sorted(answers) == sorted(f"{i}/{j}" for i in range(n_threads)
                                     for j in range(per_thread))
    assert snap["requests"] == snap["batched_rows"] == n
    assert sum(snap["bucket_hist"].values()) == snap["batches"] >= n // 4
    assert 1 <= snap["max_batch_seen"] <= 4
    snap["bucket_hist"]["99"] = 1                   # a copy, not the live dict
    assert "99" not in engine.stats_snapshot()["bucket_hist"]


def test_build_engine_from_a_native_checkpoint(tmp_path):
    """save_model -> build_engine(device='cpu') -> a request."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from util_tokenizer import make_tiny_tokenizer

    from llavamod_tpu_torch.models.builder import load_model, save_model
    from llavamod_tpu_torch.serve.server import build_engine

    cfg = _cfg()
    model = llava.init(cfg, torch.Generator().manual_seed(1))
    d = str(tmp_path / "model")
    save_model(d, model)
    cfg2, model2 = load_model(d, device="cpu")
    assert cfg2 == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    make_tiny_tokenizer(d)
    engine = build_engine(d, device="cpu", max_prompt_len=48,
                          default_max_new=3, batch_window=0.01)
    try:
        out = engine.submit(engine.runner.build_prompt("hello", False), None, 3)
        assert out["usage"]["completion_tokens"] <= 3
        assert engine.runner.device == torch.device("cpu")
    finally:
        engine.shutdown()


@pytest.mark.parametrize("template,stop", [("qwen", "<|endoftext|>"),
                                           ("mpt", "<|im_end|>")])
def test_responses_end_at_the_template_stop_string(template, stop):
    """The batcher passes the runner's stop machinery (the template's stop
    string, the tokenizer's EOS) into generation, as the JAX eval runner
    does; the JAX server's batcher passes only the EOS id, so there the
    stop string never ends a response."""
    from llavamod_tpu_torch.generation import GenerationConfig, generate

    class StopTok(CharTok):
        stop_id = None

        def __call__(self, text):
            if text == stop and self.stop_id is not None:
                return types.SimpleNamespace(input_ids=[self.stop_id])
            return super().__call__(text)

    cfg = _cfg()
    tok = StopTok()
    runner = VQARunner(model=llava.init(cfg, torch.Generator().manual_seed(2)),
                       tokenizer=tok,
                       image_preprocessor=make_image_preprocessor(cfg),
                       template_name=template, max_prompt_len=64)
    prompt = runner.build_prompt("what is item 3?", False)
    ids = generate(runner.model, runner._encode_batch([prompt], [None]),
                   GenerationConfig(max_new_tokens=6))[0].tolist()
    # the first position whose token has not come before: stop there
    cut = next(i for i in range(1, 6) if ids[i] not in ids[:i])
    engine = BatchingEngine(runner, max_batch=1, batch_window=0.01,
                            default_max_new=6)
    try:
        free = engine.submit(prompt, None, 6)
        tok.stop_id = ids[cut]
        stopped = engine.submit(prompt, None, 6)
    finally:
        engine.shutdown()
    assert free["usage"]["completion_tokens"] == 6
    assert stopped["usage"]["completion_tokens"] == cut
    assert stopped["text"] == free["text"][:cut]


class _SamplingEcho(BatchingEngine):
    """The batcher without a model: answers each request with the
    (temperature, top_p) of the batch it ran in."""

    def _run_batch(self, reqs):
        self._count_batch(len(reqs), _bucket(len(reqs), self.max_batch))
        for r in reqs:
            r.result = {"id": r.rid, "text": r.prompt,
                        "batch": [list(q.sampling) for q in reqs]}
            r.event.set()


def test_each_request_keeps_its_temperature_and_top_p():
    """Requests drained together run as one batch per distinct
    (temperature, top_p), each with its own values (the JAX server ignores
    both fields of the request)."""
    engine = _SamplingEcho(types.SimpleNamespace(
        build_prompt=lambda q, has_image: q), max_batch=8, batch_window=0.5,
        temperature=0.0, top_p=1.0)
    server, url = _serve(engine)
    wants = [{}, {"temperature": 0.7}, {"temperature": 0.7, "top_p": 0.9},
             {"top_p": 0.9}, {"temperature": 0.7}, {}]
    results = [None] * len(wants)

    def fire(i):
        results[i] = _post(url, {"prompt": str(i), **wants[i]})

    try:
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(wants))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    for want, out in zip(wants, results):
        own = [want.get("temperature", 0.0), want.get("top_p", 1.0)]
        assert out["batch"] and all(s == own for s in out["batch"]), out
    assert engine.stats["batches"] >= 4


def test_hot_requests_sample_and_cold_ones_stay_greedy(served):
    engine, runner, url = served
    greedy = _post(url, {"prompt": "name a color", "max_new_tokens": 6})
    cold = _post(url, {"prompt": "name a color", "max_new_tokens": 6,
                       "temperature": 0.0, "top_p": 0.5})
    hot = _post(url, {"prompt": "name a color", "max_new_tokens": 6,
                      "temperature": 50.0})
    assert cold["text"] == greedy["text"]
    assert hot["text"] != greedy["text"]


def test_build_engine_serves_int8(tmp_path):
    """build_engine(quant='int8') serves the int8 W8A8 form of the model
    (models/builder.py `quantize_for_serving`)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from util_tokenizer import make_tiny_tokenizer

    from llavamod_tpu_torch.models.builder import save_model
    from llavamod_tpu_torch.models.params import Int8Weight
    from llavamod_tpu_torch.serve.server import build_engine

    d = str(tmp_path / "model")
    save_model(d, llava.init(_cfg(), torch.Generator().manual_seed(1)))
    make_tiny_tokenizer(d)
    engine = build_engine(d, device="cpu", quant="int8", max_prompt_len=48,
                          default_max_new=3, batch_window=0.01)
    try:
        llm = engine.runner.model.llm
        assert isinstance(llm.embed.embedding, Int8Weight)
        assert isinstance(llm.lm_head.weight, Int8Weight)
        assert isinstance(llm.layers[0].mlp.experts.up, Int8Weight)
        out = engine.submit(engine.runner.build_prompt("hello", False), None, 3)
        assert 0 < out["usage"]["completion_tokens"] <= 3
    finally:
        engine.shutdown()
    with pytest.raises(ValueError):
        build_engine(d, device="cpu", quant="int4")


def test_shutdown_frees_the_decode_graphs(monkeypatch):
    """The engine's greedy batches decode on a graph entry that the model
    keeps (its step run eagerly here, where the card replays it); shutting
    the engine down frees the entries, though the model lives on."""
    from llavamod_tpu_torch import generation

    monkeypatch.setattr(generation, "decode_graph_path",
                        lambda *a: ("graph", None))
    monkeypatch.setattr(generation._GraphEntry, "run",
                        lambda self, model, gcfg, state, sp:
                        generation._step(model, gcfg, state, None))
    cfg = _cfg()
    model = llava.init(cfg, torch.Generator().manual_seed(0))
    runner = VQARunner(model=model, tokenizer=CharTok(),
                       image_preprocessor=make_image_preprocessor(cfg),
                       template_name="qwen", max_prompt_len=64)
    engine = BatchingEngine(runner, max_batch=2, batch_window=0.01,
                            default_max_new=4)
    try:
        text = engine.submit("what is this?", None, 4, timeout=120)["text"]
        assert generation.decode_graph_stats()["entries"] == 1
    finally:
        engine.shutdown()
    assert model not in generation._ENTRIES
    assert isinstance(text, str)
