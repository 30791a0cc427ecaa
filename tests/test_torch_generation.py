"""The whole serving slice on the CPU: the port's greedy `generate` and
`generate_stream` on a left-padded multimodal batch give the same token ids
as the JAX package's `generate`, with the same weights.  The JAX side
decodes through its XLA branch (LLAVAMOD_DECODE_ATTN=xla), which changes
nothing in the JAX package."""

import jax
import numpy as np
import pytest
from util_torch_port import (
    jax_batch,
    matched_llava,
    multimodal_arrays,
    tiny_llava_config,
    torch_batch,
)

from llavamod_tpu import generation as jgen
from llavamod_tpu_torch import generation as tgen

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
