"""Graphed decode on the card (generation.py `_GraphEntry`): a greedy
decode step captured once as a CUDA graph and replayed gives the eager
step's tokens and logits, on a small dense and a small MoE LLaVA (and the
MoE one in W8A8), one and eight rows, a bf16 and an int8 KV cache; a batch
of the same shape replays the entry, a new shape frees it before making
its own; kernel K2's launch counter counts the replayed launches, and the
profiler sees a replay run K2's kernels on every layer; sampled and
parallel generation run the eager step and say why; the entry goes with
the model.  Needs a CUDA
device, so these tests carry the `gpu` marker and skip elsewhere; run them
on the card with

    python -m pytest tests/test_torch_gpu_decode_graph.py -m gpu
"""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from llavamod_tpu_torch import generation as gen
from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.builder import quantize_for_serving
from llavamod_tpu_torch.models.llava import LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.vision.vit import tiny_vision_config
from llavamod_tpu_torch.ops.decode_attention import flash_decode
from llavamod_tpu_torch.runtime import trace

pytestmark = pytest.mark.gpu

T = 48                  # prompt slots
STEPS = 6               # decode steps a batch
LOGIT_TOL = 2e-3
MIB = 2 ** 20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs, kernel K2")
    gen._ENTRIES.clear()
    trace.collect()
    yield torch.device("cuda", 0)
    trace.disable()
    trace.collect()
    gen._ENTRIES.clear()


def _model(kind: str, dev) -> llava.Llava:
    """A small LLaVA in bf16 on the card: heads of 128 (K1, K2), a tower
    with heads of 64; 'moe' routes layers 0 and 2 over 4 experts with
    seeded routers; 'moe_w8a8' is that model quantized for serving."""
    moe = kind.startswith("moe")
    llm = tiny_config(vocab_size=1024, hidden_size=256, intermediate_size=512,
                      num_layers=4, num_heads=2, num_kv_heads=2,
                      **(dict(moe_num_experts=4, moe_layers=(0, 2))
                         if moe else {}))
    cfg = LlavaConfig(llm=llm, vision=tiny_vision_config(
        hidden_size=128, num_heads=2, intermediate_size=256),
        projector_type="mlp2x_gelu", max_images=1)
    model = llava.init(cfg, torch.Generator().manual_seed(0))
    if moe:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for i in llm.moe_layers:
                model.llm.layers[i].mlp.router.normal_(generator=g)
    model = model.to(dev, torch.bfloat16)
    if kind == "moe_w8a8":
        model = quantize_for_serving(model)
    return model


def _batch(cfg: LlavaConfig, b: int, seed: int, dev) -> MultimodalBatch:
    """A left-padded batch of b prompts of T slots, each with one image."""
    rng = np.random.RandomState(seed)
    n_img = cfg.num_image_tokens
    s = cfg.vision.image_size
    ids = rng.randint(1, cfg.llm.vocab_size, (b, T)).astype(np.int32)
    seg = np.zeros((b, T), np.int32)
    mask = np.zeros((b, T), bool)
    pos = np.zeros((b, T), np.int32)
    for i, n in enumerate(rng.randint(n_img + 4, T + 1, size=b)):
        seg[i, T - n:] = 1
        ids[i, :T - n] = 0
        st = T - n + 1
        mask[i, st:st + n_img] = True
        pos[i, st:st + n_img] = i * n_img + np.arange(n_img)
        ids[i, st:st + n_img] = 0
    return MultimodalBatch(
        torch.tensor(ids, device=dev), torch.tensor(seg, device=dev),
        torch.tensor(mask, device=dev), torch.tensor(pos, device=dev),
        torch.tensor(rng.randn(b, 1, 3, s, s), dtype=torch.bfloat16,
                     device=dev),
        torch.ones((b, 1), dtype=torch.bool, device=dev))


def _decode(model, batch, gcfg):
    """(ids [B, STEPS + 1], each step's logits), copied as they come: a
    replay overwrites the graph's output buffers."""
    with torch.inference_mode():
        state = gen._prefill(model, batch, gcfg, None)
        ids, logits = [state.tok.clone()], []
        for _ in range(STEPS):
            ids.append(gen._decode_steps(model, gcfg, state, 1, None)[:, 0])
            logits.append(state.logits.clone())
        torch.cuda.synchronize()
    return torch.stack(ids, 1), logits


def _eager(model, batch, gcfg):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gen, "decode_graph_path", lambda *a: ("eager", "forced"))
        return _decode(model, batch, gcfg)


def _delta(before: dict) -> dict:
    now = gen.decode_graph_stats()
    eager = {k: v - before["eager"].get(k, 0) for k, v in now["eager"].items()
             if v != before["eager"].get(k, 0)}
    return {"captures": now["captures"] - before["captures"],
            "replays": now["replays"] - before["replays"], "eager": eager}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("kind", ["dense", "moe", "moe_w8a8"])
def test_graphed_decode_matches_the_eager_step(dev, kind, b, cache_dtype):
    model = _model(kind, dev)
    layers = model.cfg.llm.num_layers
    gcfg = gen.GenerationConfig(max_new_tokens=STEPS + 1,
                                cache_dtype=cache_dtype)
    int8 = cache_dtype == "int8"
    for seed in (1, 2):           # the second batch: other prompts
        batch = _batch(model.cfg, b, seed, dev)
        n0, i0 = flash_decode.launches, flash_decode.int8_launches
        want_ids, want_logits = _eager(model, batch, gcfg)
        assert flash_decode.launches - n0 == layers * STEPS
        before = gen.decode_graph_stats()
        n0, i0 = flash_decode.launches, flash_decode.int8_launches
        trace.enable()
        ids, logits = _decode(model, batch, gcfg)
        trace.disable()
        # K2 is launched (captured, then replayed) on every layer and step
        assert flash_decode.launches - n0 == layers * STEPS
        assert flash_decode.int8_launches - i0 == layers * STEPS * int8
        assert torch.equal(ids, want_ids)
        worst = max((a - w).abs().max().item()
                    for a, w in zip(logits, want_logits))
        assert worst <= LOGIT_TOL, worst
        paths = [s["attrs"].get("graph") for s in trace.collect()
                 if s["name"] == "generate.decode_step"]
        if seed == 1:             # a new shape: warm-up, capture, replays
            assert paths == ["eager", "capture"] + ["replay"] * (STEPS - 2)
            assert _delta(before) == {"captures": 1, "replays": STEPS - 1,
                                      "eager": {"warm-up": 1}}
        else:                     # the entry is reused
            assert paths == ["replay"] * STEPS
            assert _delta(before) == {"captures": 0, "replays": STEPS,
                                      "eager": {}}
        # generate on the graph: its first token is the prefill's
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gen, "decode_graph_path",
                       lambda *a: ("eager", "forced"))
            want_gen = gen.generate(model, batch, gcfg)
        assert (gen.generate(model, batch, gcfg) == want_gen).all()
        assert (want_gen == want_ids.cpu().numpy()).all()
    assert gen.decode_graph_stats()["entries"] == 1


def test_entries_are_bounded_evicted_and_freed_with_the_model(dev):
    # a long budget, so that each cache outweighs the margins below
    gcfg = gen.GenerationConfig(max_new_tokens=8192)
    # a first model warms what outlives it (the side stream's cuBLAS
    # workspaces, the kernels' modules)
    warm = _model("moe", dev)
    _decode(warm, _batch(warm.cfg, 8, 1, dev), gcfg)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)

    model = _model("moe", dev)
    cache_bytes = {}
    prev = None
    for i, b in enumerate((8, 4, 4)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _decode(model, _batch(model.cfg, b, 10 + i, dev), gcfg)
        entry = gen._ENTRIES[model]
        assert entry.key[0] == b
        c = entry.state.cache
        cache_bytes[b] = sum(x.numel() * x.element_size()
                             for x in (c.k, c.v, c.segment))
        if i:
            # no moment held a second cache beside the held one (a cache
            # of 4 rows is 135 MB here)
            assert torch.cuda.max_memory_allocated(dev) <= held + 32 * MIB
        if i == 1:
            # a new shape: the old entry went before the new cache came
            assert prev() is None
            assert torch.cuda.memory_allocated(dev) <= (
                held - cache_bytes[8] + cache_bytes[4] + 32 * MIB)
        elif i == 2:              # the same shape: the entry is reused
            assert prev() is entry
        prev = weakref.ref(entry)
        del entry, c
    assert prev() is not None and cache_bytes[8] > 64 * MIB
    stats = gen.decode_graph_stats()
    assert stats["entries"] == 1
    assert stats["bytes"] == gen._ENTRIES[model].bytes >= cache_bytes[4]

    del model
    gc.collect()
    torch.cuda.empty_cache()
    assert gen.decode_graph_stats()["entries"] == 0
    left = torch.cuda.memory_allocated(dev) - base
    assert left <= 64 * MIB, left / MIB


def test_a_replay_runs_k2_on_every_layer(dev):
    """The profiler sees a replayed step run as many of K2's kernels as
    the eager step does, on every layer (K2's launch counter only counts
    what the capture recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model("moe", dev)
    batch = _batch(model.cfg, 8, 4, dev)
    gcfg = gen.GenerationConfig(max_new_tokens=STEPS + 1)
    _decode(model, batch, gcfg)              # warm-up, capture, replays

    def k2_kernels(path):
        with pytest.MonkeyPatch.context() as mp:
            if path == "eager":
                mp.setattr(gen, "decode_graph_path",
                           lambda *a: ("eager", "forced"))
            with torch.inference_mode():
                state = gen._prefill(model, batch, gcfg, None)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    gen._decode_steps(model, gcfg, state, 1, None)
                    torch.cuda.synchronize()
        assert (state.entry is None) == (path == "eager")
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and "flash_decode" in e.name())

    replayed, eager = k2_kernels("replay"), k2_kernels("eager")
    assert replayed == eager
    assert replayed % model.cfg.llm.num_layers == 0 and replayed > 0


def test_sampled_and_parallel_generation_run_the_eager_step(dev, monkeypatch):
    model = _model("moe", dev)
    layers = model.cfg.llm.num_layers
    batch = _batch(model.cfg, 8, 3, dev)
    cases = [("sampled", gen.GenerationConfig(max_new_tokens=STEPS + 1,
                                              temperature=0.7)),
             ("parallel", gen.GenerationConfig(max_new_tokens=STEPS + 1))]
    for reason, gcfg in cases:
        if reason == "parallel":
            # a context of one rank: the decision reads that one is active
            monkeypatch.setattr(gen, "parallel_context", lambda: (
                types.SimpleNamespace(tensor_size=1, pipe_size=1)))
        before = gen.decode_graph_stats()
        n0 = flash_decode.launches
        gen.generate(model, batch, gcfg,
                     generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        assert _delta(before) == {"captures": 0, "replays": 0,
                                  "eager": {reason: STEPS}}
        assert flash_decode.launches - n0 == layers * STEPS
    assert gen.decode_graph_stats()["entries"] == 0
