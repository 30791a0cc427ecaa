"""The whole serving slice on the CPU: the port's greedy `generate` and
`generate_stream` on a left-padded multimodal batch give the same token ids
as the JAX package's `generate`, with the same weights.  The JAX side
decodes through its XLA branch (LLAVAMOD_DECODE_ATTN=xla), which changes
nothing in the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from util_torch_port import (
    jax_batch,
    matched_llava,
    multimodal_arrays,
    tiny_llava_config,
    torch_batch,
)

from llavamod_tpu import generation as jgen
from llavamod_tpu_torch import generation as tgen
from llavamod_tpu_torch.models import llava as tllava

NEW = 6


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_llava_config()
    jcfg, params, model = matched_llava(cfg, seed=7)
    arrays = multimodal_arrays(cfg, [16, 11, 5], 20, seed=8,
                               with_image=[True, False, True])
    return cfg, jcfg, params, model, arrays


def _jax_ids(params, jcfg, arrays, **gkw):
    return jgen.generate(params, jcfg, jax_batch(arrays),
                         jgen.GenerationConfig(max_new_tokens=NEW,
                                               cache_dtype="float32", **gkw),
                         rng=jax.random.PRNGKey(0))


def test_greedy_generate_matches_jax(setup, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg, jcfg, params, model, arrays = setup
    want = _jax_ids(params, jcfg, arrays)
    got = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
        max_new_tokens=NEW, cache_dtype="float32"))
    assert got.shape == (3, NEW)
    assert (got == want).all(), (got, want)

    # stop machinery: an EOS id and a two-token stop sequence taken from the
    # output truncate both sides at the same place
    eos = int(want[0, 3])
    stop = (int(want[2, 1]), int(want[2, 2]))
    want_s = _jax_ids(params, jcfg, arrays, eos_token_ids=(eos,),
                      stop_sequences=(stop,))
    got_s = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
        max_new_tokens=NEW, cache_dtype="float32", eos_token_ids=(eos,),
        stop_sequences=(stop,)))
    assert (got_s == want_s).all(), (got_s, want_s)
    assert (got_s != got).any()


def test_generate_stream_concatenates_to_generate(setup, monkeypatch):
    monkeypatch.setenv("LLAVAMOD_DECODE_ATTN", "xla")
    cfg, jcfg, params, model, arrays = setup
    want = _jax_ids(params, jcfg, arrays)
    gcfg = tgen.GenerationConfig(max_new_tokens=NEW, cache_dtype="float32")
    parts = list(tgen.generate_stream(model, torch_batch(arrays), gcfg,
                                      chunk=2))
    assert [p.shape[1] for p in parts] == [1, 2, 2, 1]
    assert (np.concatenate(parts, axis=1) == want).all()


def test_bf16_cache_and_int8_cache_decode(setup):
    """Other cache dtypes run the same path (K2's plain version reads the
    cache in its stored dtype); greedy ids stay close to the f32 run."""
    cfg, jcfg, params, model, arrays = setup
    ref = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
        max_new_tokens=NEW, cache_dtype="float32"))
    for dt in ("bfloat16", "int8"):
        got = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
            max_new_tokens=NEW, cache_dtype=dt))
        assert got.shape == ref.shape
        assert (got[:, 0] == ref[:, 0]).all()   # prefill is cache-independent


class _Stub:
    """Just what `decode_graph_path` reads of a model."""

    def __init__(self, **llm_kw):
        self.cfg = tiny_llava_config(**llm_kw)


@pytest.mark.parametrize("case,want", [
    ("greedy", ("graph", None)),
    ("cpu", ("eager", "not_cuda")),
    ("sampled", ("eager", "sampled")),
    ("parallel", ("eager", "parallel")),
    ("sharded", ("eager", "sharded")),
    ("ragged", ("eager", "ragged_dispatch")),
    ("einsum", ("graph", None)),
    ("alibi", ("eager", "alibi")),
    ("dynamic_ntk", ("eager", "dynamic_ntk")),
])
def test_decode_graph_path_and_its_reason(case, want, monkeypatch):
    """The decode step is a graph replay only on the card, greedy, outside
    a parallel context, unsharded, and where nothing in the step needs the
    host; every other case names what stops it."""
    llm_kw = {"ragged": dict(moe_dispatch="ragged"),
              "einsum": dict(moe_dispatch="einsum"),
              "alibi": dict(alibi=True, use_rope=False),
              "dynamic_ntk": dict(use_dynamic_ntk=True)}.get(case, {})
    gcfg = tgen.GenerationConfig(temperature=0.7 if case == "sampled"
                                 else 0.0)
    if case == "parallel":
        monkeypatch.setattr(tgen, "parallel_context", lambda: object())
    if case == "sharded":
        monkeypatch.setattr(tgen, "is_sharded", lambda m: True)
    dev = torch.device("cpu" if case == "cpu" else "cuda")
    assert tgen.decode_graph_path(_Stub(**llm_kw), gcfg, dev) == want


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: the entry's step runs eagerly where the
    card captures and replays it.  Yields the paths of the steps taken."""
    monkeypatch.setattr(tgen, "decode_graph_path", lambda *a: ("graph", None))
    runs = []

    def run(self, model, gcfg, state, sp):
        runs.append(state.cache.length)
        return tgen._step(model, gcfg, state, None)

    monkeypatch.setattr(tgen._GraphEntry, "run", run)
    tgen._ENTRIES.clear()
    yield runs
    tgen._ENTRIES.clear()


_CACHE_FIELDS = ("k", "v", "segment", "k_scale", "v_scale")


def _decode(model, arrays, gcfg, steps):
    """(ids [B, steps + 1], each step's logits, the done mask, the cache's
    tensors), copied: a graph entry's buffers serve its next batch."""
    with torch.inference_mode():
        state = tgen._prefill(model, torch_batch(arrays), gcfg, None)
        ids, logits = [state.tok.clone()], []
        for _ in range(steps):
            ids.append(tgen._decode_steps(model, gcfg, state, 1, None)[:, 0])
            logits.append(state.logits.clone())
        cache = {n: getattr(state.cache, n) for n in _CACHE_FIELDS}
        return (torch.stack(ids, 1), logits, state.done.clone(),
                {n: None if x is None else x.clone()
                 for n, x in cache.items()})


def _with_stops(setup, cache_dtype):
    """A config whose EOS id and two-token stop string cut rows early."""
    cfg, jcfg, params, model, arrays = setup
    plain = tgen.generate(model, torch_batch(arrays), tgen.GenerationConfig(
        max_new_tokens=NEW, cache_dtype=cache_dtype))
    return tgen.GenerationConfig(
        max_new_tokens=NEW, cache_dtype=cache_dtype,
        eos_token_ids=(int(plain[0, 3]),),
        stop_sequences=((int(plain[2, 1]), int(plain[2, 2])),))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_graph_step_matches_the_eager_step(setup, graphed, cache_dtype):
    """The step a graph captures (the entry's buffers advanced in place,
    the K/V written at a device-tensor slot) gives the eager step's ids,
    logits, done mask and cache, bit for bit, for two batches of one shape
    through one entry: the second prefill reuses the first's cache, whose
    unwritten tail it zeroes."""
    cfg, jcfg, params, model, arrays = setup
    other = multimodal_arrays(cfg, [9, 20, 14], 20, seed=9,
                              with_image=[False, True, True])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "decode_graph_path", lambda *a: ("eager", "forced"))
        gcfg = _with_stops(setup, cache_dtype)
        want = [_decode(model, a, gcfg, NEW - 1) for a in (arrays, other)]
    got = [_decode(model, a, gcfg, NEW - 1) for a in (arrays, other)]
    assert graphed == 2 * list(range(20, 20 + NEW - 1))   # host lengths
    assert got[0][2].any()                  # the stops cut the first batch
    # through generate, whose first token the steps must not overwrite
    for a, (wids, *_) in zip((arrays, other), want):
        ids = tgen.generate(model, torch_batch(a), gcfg)
        assert (ids == tgen.truncate_at_stops(wids.numpy(), gcfg)).all()
    assert tgen.decode_graph_stats()["entries"] == 1
    for (ids, logits, done, cache), (wids, wlogits, wdone, wcache) in zip(
            got, want):
        assert torch.equal(ids, wids)
        assert all(torch.equal(a, b) for a, b in zip(logits, wlogits))
        assert torch.equal(done, wdone)
        for name in _CACHE_FIELDS:
            a, w = cache[name], wcache[name]
            assert (a is None and w is None) or torch.equal(a, w), name


def test_graph_entries_are_bounded_and_go_with_the_model(setup, graphed):
    """A model keeps one entry: a new shape frees the old one before it
    makes its own; a state whose cache a later prefill took refuses to
    decode; the entry goes when the model does; generate_stream runs on
    the entry and gives generate's ids."""
    import gc
    import weakref

    cfg, jcfg, params, model, arrays = setup
    fresh = tllava.init(cfg, torch.Generator().manual_seed(7))
    fresh.load_state_dict(model.state_dict())
    gcfg = tgen.GenerationConfig(max_new_tokens=NEW, cache_dtype="float32")
    want = tgen.generate(fresh, torch_batch(arrays), gcfg)
    parts = list(tgen.generate_stream(fresh, torch_batch(arrays), gcfg,
                                      chunk=2))
    assert (np.concatenate(parts, axis=1) == want).all()
    key = lambda: tgen._ENTRIES[fresh].key[:2]  # noqa: E731
    assert key() == (3, 20 + NEW)
    made, prev = [], [None]
    real_init = tgen._GraphEntry.__init__

    def init(self, *a, **kw):
        made.append(prev[0]() is None)   # the old entry went first
        real_init(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen._GraphEntry, "__init__", init)
        for new in (NEW - 2, NEW - 2, NEW):
            prev[0] = weakref.ref(tgen._ENTRIES[fresh])
            tgen.generate(fresh, torch_batch(arrays),
                          dataclasses.replace(gcfg, max_new_tokens=new))
            assert key() == (3, 20 + new)
    assert made == [True, True]             # the repeat made none
    stats = tgen.decode_graph_stats()
    assert stats["entries"] == 1 and stats["bytes"] > 0

    with torch.inference_mode():
        first = tgen._prefill(fresh, torch_batch(arrays), gcfg, None)
        tgen._prefill(fresh, torch_batch(arrays), gcfg, None)
        with pytest.raises(RuntimeError, match="taken"):
            tgen._decode_steps(fresh, gcfg, first, 1, None)
    del first, fresh
    gc.collect()
    assert tgen.decode_graph_stats()["entries"] == 0
