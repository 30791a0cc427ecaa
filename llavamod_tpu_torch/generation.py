"""Batched autoregressive generation with a static KV cache (port of
llavamod_tpu/generation.py).

One prefill (multimodal splice included) fills a preallocated cache of
`t + max_new_tokens` slots, then one decoder step per token; greedy or
temperature/top-k/top-p sampling; early stop via a done mask.  Everything
runs under torch.inference_mode() (a sharded model under no_grad).

Prompts must be LEFT-padded (segment 0 on the left) so every sequence's
next-token slot is the last position; positions are segment-aware so RoPE
sees 0 at each sequence's first real token.  The cache `length` is one
scalar shared by all rows; decode positions are prompt_len + i.

Under a parallel context (parallel/collectives.py `active`) with a model
that parallel/sharding.py `shard_params` sharded over a (data, fsdp,
expert, tensor, pipe) mesh, each rank generates for its rows (the ranks of
a tensor group, and of a pipe group, hold the same rows): the cache holds
the rank's KV heads of its stage's layers, kernel K2 runs on them, the
vocab-parallel logits are gathered whole on every tensor rank before
`_sample`, and with temperature > 0 tensor rank 0's token is broadcast to
its group, then pipe rank 0's to its (the generators of the ranks need not
agree; greedy decoding picks the same token on every rank).  Under pipe >
1 each prefill and decode step runs the stages in turn
(parallel/pipeline.py `sequential_layers`: K1 on each stage's layers in
the prefill, K2 on its cache slots in a step), and the last stage's hidden
reaches every stage, where the head runs.  Every rank runs the same number
of prefill and decode forwards, so the FSDP2 gathers, the expert exchange
and the stages' transfers stay in lockstep: the loop runs exactly
`max_new_tokens - 1` steps, and `generate_stream` stops early only when
the done rows of every rank agree.  The prefill goes through the model's
module call (FSDP2 gathers the tower, the projector and each layer in
their hooks) and the root unit (embedding, final norm, head) is held
gathered around the prefill and each run of decode steps.

Every decode step (`_step`) reads and advances a `_DecodeState`'s buffers in
place: the token, positions, done mask, stop window and the KV cache, whose
K/V it writes at a slot held in a device tensor (decoder `KVCache.slot`).
Graphed decode: on a CUDA model, outside a parallel context, unsharded and
greedy (`decode_graph_path` decides from these, the configuration and the
device; there is no switch), that step runs on a `_GraphEntry` the model
keeps between batches, keyed by (rows, cache slots, cache dtype, stop
machinery, weights).  A model keeps one entry: a batch of another shape
frees it before its own cache is allocated, and the entry goes with the
model.  The prefill writes into the entry's KV cache; the entry's first
step runs eagerly (it warms cuBLAS and K2 on the capture stream), its
second is captured as one `torch.cuda.CUDAGraph` (embed, decoder with the
cache, head, greedy pick, done and stop window) and replayed, and every
later step of every batch of that shape is one replay: the same kernels, K2
and the cuBLAS GEMMs, without the host's ~3,000 launches a step.  So the
replays pay off where batches repeat a shape; a new shape costs one eager
step and one capture.  Sampled decoding, tensor and pipeline generation,
sharded models, ALiBi, dynamic NTK, the ragged MoE dispatch (it reads
expert counts on the host) and the CPU call the same step eagerly.  Each
`generate.decode_step` span says which (`graph`: "replay", "capture" or
"eager", with `reason` when eager); `decode_graph_stats()` counts them.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import itertools
import weakref
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.llava import Llava, MultimodalBatch
from llavamod_tpu_torch.ops.decode_attention import flash_decode
from llavamod_tpu_torch.parallel.collectives import (
    current as parallel_context,
    tensor_gather,
    tensor_size,
)
from llavamod_tpu_torch.parallel.sharding import gathered, is_sharded
from llavamod_tpu_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => disabled
    top_p: float = 1.0
    eos_token_ids: Tuple[int, ...] = ()
    # multi-token stop strings as token-id sequences
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    pad_token_id: int = 0
    cache_dtype: str = "bfloat16"


_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": "int8"}


def _sample(logits: torch.Tensor, gcfg: GenerationConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits [B, V] -> next ids [B] (int32)."""
    if gcfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / gcfg.temperature
    if gcfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -gcfg.top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if gcfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < gcfg.top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _next_logits(model: Llava, hidden: torch.Tensor) -> torch.Tensor:
    """[B, 1, D] -> logits [B, V], whole on every tensor rank."""
    logits = llava.logits(model, model.cfg, hidden)[:, 0]
    pctx = parallel_context()
    if tensor_size(pctx) > 1:
        logits = tensor_gather(logits, pctx, -1)
    return logits


def _pick(logits: torch.Tensor, gcfg: GenerationConfig,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """`_sample`, with tensor rank 0's sampled token on its whole group,
    then pipe rank 0's on its."""
    tok = _sample(logits, gcfg, generator)
    pctx = parallel_context()
    if gcfg.temperature > 0.0 and tensor_size(pctx) > 1:
        import torch.distributed as dist

        src = dist.get_process_group_ranks(pctx.tensor_group)[0]
        dist.broadcast(tok, src, group=pctx.tensor_group)
    if gcfg.temperature > 0.0 and pctx is not None and pctx.pipe_size > 1:
        tok = pctx.broadcast_stage(tok, 0)
    return tok


def _stop_machinery(gcfg: GenerationConfig, b: int, device):
    """(is_eos, push_window, window_stopped, win) closures for EOS ids and
    multi-token stop sequences."""
    eos = torch.tensor(gcfg.eos_token_ids, dtype=torch.int32, device=device)
    win = max([len(s) for s in gcfg.stop_sequences], default=0)
    stops = [torch.tensor(s, dtype=torch.int32, device=device)
             for s in gcfg.stop_sequences]

    def is_eos(tok):
        if eos.numel() == 0:
            return torch.zeros_like(tok, dtype=torch.bool)
        return (tok[:, None] == eos[None, :]).any(dim=-1)

    def push_window(window, tok):
        if win == 0:
            return window
        return torch.cat([window[:, 1:], tok[:, None]], dim=1)

    def window_stopped(window):
        hit = torch.zeros((b,), dtype=torch.bool, device=device)
        for s in stops:
            tail = window[:, win - s.shape[0]:]
            hit = hit | (tail == s[None, :]).all(dim=1)
        return hit

    return is_eos, push_window, window_stopped, win


# the decode graph each model keeps, with its KV cache: one, so that a new
# shape's cache takes the memory the old one freed
_ENTRIES: "weakref.WeakKeyDictionary[Llava, _GraphEntry]" = \
    weakref.WeakKeyDictionary()
_STATS = {"captures": 0, "replays": 0, "eager": collections.Counter()}


def decode_graph_path(model: Llava, gcfg: GenerationConfig,
                      device) -> Tuple[str, Optional[str]]:
    """("graph", None) where a decode step can be one CUDA graph replay,
    else ("eager", reason): what stops the capture, or needs the host
    inside the step."""
    llm = model.cfg.llm
    if torch.device(device).type != "cuda":
        return "eager", "not_cuda"
    if gcfg.temperature > 0.0:
        return "eager", "sampled"       # multinomial with a caller's generator
    if parallel_context() is not None:
        return "eager", "parallel"
    if is_sharded(model):
        return "eager", "sharded"
    if llm.moe_num_experts and llm.moe_dispatch == "ragged":
        return "eager", "ragged_dispatch"   # expert counts read on the host
    if llm.alibi:
        return "eager", "alibi"             # slopes copied from the host
    if llm.use_dynamic_ntk:
        return "eager", "dynamic_ntk"       # theta read on the host
    return "graph", None


def release_decode_graphs(model: Llava) -> None:
    """Free the decode graph and KV cache that `model` keeps (an entry a
    generation still holds goes when it ends)."""
    _ENTRIES.pop(model, None)


def decode_graph_stats() -> dict:
    """Decode steps by path since the process started: captures, replays,
    eager steps by reason; and the entries held now and their bytes."""
    held = list(_ENTRIES.values())
    return {"captures": _STATS["captures"], "replays": _STATS["replays"],
            "eager": dict(_STATS["eager"]), "entries": len(held),
            "bytes": sum(e.bytes for e in held)}


@functools.lru_cache(maxsize=None)
def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream every entry on `dev` warms up and captures on: one a
    device, so cuBLAS keeps one workspace for the captures."""
    return torch.cuda.Stream(dev)


class _DecodeState:
    """What the decode loop carries from step to step: the buffers a step
    reads and advances in place (the KV cache, written at the device slot
    `slot`; token, positions, done mask, stop window) with the stop
    machinery's constants, made before any capture (a copy from pageable
    host memory is illegal while a stream captures).  The host keeps the
    cache's `length`."""

    def __init__(self, model: Llava, gcfg: GenerationConfig, b: int,
                 slots: int, dev):
        self.cache = decoder.init_cache(
            model.cfg.llm, b, slots, dtype=_CACHE_DTYPES[gcfg.cache_dtype],
            device=dev)
        self.stop = _stop_machinery(gcfg, b, dev)
        self.ones = torch.ones((b, 1), dtype=torch.int32, device=dev)
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.window = torch.full((b, self.stop[3]), -1, dtype=torch.int32,
                                 device=dev)
        self.logits = None                  # the last step's [B, V]
        self.entry, self.ticket, self.reason = None, 0, None

    def start(self, cache: decoder.KVCache, first: torch.Tensor,
              done: torch.Tensor, window: torch.Tensor,
              prompt_len: torch.Tensor) -> None:
        """Take up after a prefill that wrote `cache.length` slots of
        `cache` and picked `first`."""
        self.cache = cache._replace(slot=self.slot)
        self.tok.copy_(first)
        self.done.copy_(done)
        self.window.copy_(window)
        self.pos.copy_(prompt_len[:, None])
        self.slot.fill_(cache.length)


def _step(model: Llava, gcfg: GenerationConfig, state: _DecodeState,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """One decode step on the state's buffers, advanced in place: the eager
    step, and the one a graph entry captures.  Returns its logits [B, V]."""
    cfg = model.cfg
    is_eos, push_window, window_stopped, _ = state.stop
    emb = decoder.embed(model.llm, cfg.llm, state.tok[:, None])
    dout = decoder.forward(
        model.llm, cfg.llm, inputs_embeds=emb, positions=state.pos,
        segment_ids=state.ones, cache=state.cache, train=False)
    logits = _next_logits(model, dout.hidden[:, -1:])
    nxt = torch.where(state.done, gcfg.pad_token_id,
                      _pick(logits, gcfg, generator)).to(torch.int32)
    if state.window.shape[1]:
        state.window.copy_(push_window(state.window, nxt))
    state.done |= is_eos(nxt) | window_stopped(state.window)
    state.tok.copy_(nxt)
    state.pos += 1
    state.slot += 1
    return logits


class _GraphEntry:
    """The greedy decode step of one shape of one model: its buffers (a
    `_DecodeState`, KV cache included) and, once captured, the step's CUDA
    graph, which reads and advances them."""

    def __init__(self, key: tuple, model: Llava, gcfg: GenerationConfig,
                 b: int, slots: int, dev):
        self.key, self.dev = key, dev
        self.state = s = _DecodeState(model, gcfg, b, slots, dev)
        self.bytes = sum(x.numel() * x.element_size() for x in (
            *[c for c in s.cache if isinstance(c, torch.Tensor)],
            s.ones, s.tok, s.pos, s.slot, s.done, s.window))
        self.graph = self.logits = None
        self.warm = False
        self.launches = (0, 0)              # K2's (all, int8) a step
        self.ticket = 0                     # the prefill that owns the cache

    def take(self, t: int) -> _DecodeState:
        """A state on the entry's buffers for a prefill of t slots, its
        cache as `init_cache` gives it: the prefill overwrites slots [0, t)
        of every layer and row, and the rest is zeroed."""
        c = self.state.cache
        slots = c.segment.shape[1]
        for x in (c.k, c.v, c.k_scale, c.v_scale):
            if x is not None:
                x.narrow(3, t, slots - t).zero_()
        c.segment.narrow(1, t, slots - t).zero_()
        self.ticket += 1
        state = copy.copy(self.state)
        state.entry, state.ticket = self, self.ticket
        return state

    def run(self, model: Llava, gcfg: GenerationConfig, state: _DecodeState,
            sp) -> torch.Tensor:
        """One step: the shape's first eagerly on the capture stream, its
        second captured and replayed, every later one a replay.  Records
        the path on span `sp`."""
        if self.graph is None and not self.warm:
            _STATS["eager"]["warm-up"] += 1
            sp.set(graph="eager", reason="warm-up")
            cur = torch.cuda.current_stream(self.dev)
            side = _side_stream(self.dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                logits = _step(model, gcfg, state, None)
            cur.wait_stream(side)
            logits.record_stream(cur)
            self.warm = True
            return logits
        mode = "replay"
        if self.graph is None:
            self._capture(model, gcfg, state)
            mode = "capture"
        self.graph.replay()
        flash_decode.launches += self.launches[0]
        flash_decode.int8_launches += self.launches[1]
        _STATS["replays"] += 1
        sp.set(graph=mode)
        return self.logits

    def _capture(self, model: Llava, gcfg: GenerationConfig,
                 state: _DecodeState) -> None:
        torch.cuda.synchronize(self.dev)
        reserved = torch.cuda.memory_reserved(self.dev)
        counts = (flash_decode.launches, flash_decode.int8_launches)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(_side_stream(self.dev)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    logits = _step(model, gcfg, state, None)
                finally:
                    graph.capture_end()
        finally:
            # the capture launched nothing; each replay adds its launches
            self.launches = (flash_decode.launches - counts[0],
                             flash_decode.int8_launches - counts[1])
            flash_decode.launches, flash_decode.int8_launches = counts
        self.graph, self.logits = graph, logits
        self.bytes += torch.cuda.memory_reserved(self.dev) - reserved
        _STATS["captures"] += 1


def _graph_entry(model: Llava, gcfg: GenerationConfig, b: int, slots: int,
                 dev) -> _GraphEntry:
    """The model's entry for this shape.  A model keeps one: the entry of
    another shape is freed before the new one allocates its cache.  The
    key holds the addresses of the decoder's tensors: a graph reads the
    weights where they lay at its capture."""
    weights = tuple(x.data_ptr() for x in itertools.chain(
        model.llm.parameters(), model.llm.buffers()))
    key = (b, slots, gcfg.cache_dtype, gcfg.eos_token_ids,
           gcfg.stop_sequences, gcfg.pad_token_id, weights)
    entry = _ENTRIES.get(model)
    if entry is None or entry.key != key:
        entry = None
        _ENTRIES.pop(model, None)
        entry = _ENTRIES[model] = _GraphEntry(key, model, gcfg, b, slots, dev)
    return entry


def _prefill(model: Llava, batch: MultimodalBatch, gcfg: GenerationConfig,
             generator: Optional[torch.Generator]) -> _DecodeState:
    """Encode the multimodal prompt into a fresh cache (a graph entry's,
    where `decode_graph_path` allows) and sample the first token (span
    `generate.prefill`)."""
    with trace.span("generate.prefill", device=True):
        cfg = model.cfg
        b, t = batch.input_ids.shape
        dev = batch.input_ids.device
        seg = batch.segment_ids
        positions = torch.clamp_min(torch.cumsum(seg, dim=1) - 1, 0)
        prompt_len = seg.sum(dim=1)
        path, reason = decode_graph_path(model, gcfg, dev)
        slots = t + gcfg.max_new_tokens
        if path == "graph" and gcfg.max_new_tokens > 1:
            state = _graph_entry(model, gcfg, b, slots, dev).take(t)
        else:
            state = _DecodeState(model, gcfg, b, slots, dev)
            state.reason = reason
        # attn_impl="fresh": the cache is empty, so prefill attention runs
        # on the chunk's own K/V (kernel K1 on the card) while the cache is
        # written; a sharded model through its module call
        fwd = model if is_sharded(model) else functools.partial(
            llava.forward, model, cfg)
        out = fwd(batch._replace(positions=positions), cache=state.cache,
                  train=False, attn_impl="fresh")
        last_logits = _next_logits(model, out.hidden[:, -1:])

        is_eos, push_window, window_stopped, win = state.stop
        first = _pick(last_logits, gcfg, generator)
        window = push_window(torch.full((b, win), -1, dtype=torch.int32,
                                        device=dev), first)
        state.start(out.cache, first, is_eos(first) | window_stopped(window),
                    window, prompt_len)
        return state


def _decode_steps(model: Llava, gcfg: GenerationConfig, state: _DecodeState,
                  n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Decode `n` tokens from `state` (advanced in place), one span
    `generate.decode_step` each: a replay of the state's graph entry, else
    the eager step.  Returns [B, n]."""
    entry = state.entry
    if entry is not None and state.ticket != entry.ticket:
        raise RuntimeError("another generation of this shape has since "
                           "taken the decode graph's KV cache")
    slots = state.cache.segment.shape[1]
    toks = []
    for _ in range(n):
        length = state.cache.length
        if length >= slots:
            raise ValueError(f"cache of {slots} slots cannot take 1 more "
                             f"after {length}")
        with trace.span("generate.decode_step", device=True) as sp:
            if entry is None:
                _STATS["eager"][state.reason] += 1
                sp.set(graph="eager", reason=state.reason)
                state.logits = _step(model, gcfg, state, generator)
            else:
                state.logits = entry.run(model, gcfg, state, sp)
            toks.append(state.tok.clone())
        state.cache = state.cache._replace(length=length + 1)
    return torch.stack(toks, dim=1)


def _no_grad(model: Llava):
    """inference_mode, or for a sharded model no_grad (FSDP2's gathers
    cannot write inference tensors)."""
    return torch.no_grad() if is_sharded(model) else torch.inference_mode()


def generate(model: Llava, batch: MultimodalBatch, gcfg: GenerationConfig,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Returns generated ids [B, max_new_tokens] (pad after EOS)."""
    with _no_grad(model), gathered(model):
        state = _prefill(model, batch, gcfg, generator)
        parts = [state.tok[:, None].clone()]    # the steps advance state.tok
        if gcfg.max_new_tokens > 1:
            parts.append(_decode_steps(model, gcfg, state,
                                       gcfg.max_new_tokens - 1, generator))
    gen = torch.cat(parts, dim=1)
    return truncate_at_stops(gen.cpu().numpy(), gcfg)


def generate_stream(model: Llava, batch: MultimodalBatch,
                    gcfg: GenerationConfig,
                    generator: Optional[torch.Generator] = None,
                    chunk: int = 8) -> Iterator[np.ndarray]:
    """Incremental generation: yields np arrays [B, <=chunk] of newly
    decoded ids; stops early once every sequence hit EOS/a stop string.
    The concatenation of all yields == generate(...) before stop-truncation,
    so callers apply truncate_at_stops to the accumulated ids."""
    with _no_grad(model), gathered(model):
        state = _prefill(model, batch, gcfg, generator)
        first = state.tok[:, None].clone().cpu().numpy()
    yield first
    produced = 1
    while produced < gcfg.max_new_tokens:
        if _all_done(state.done):
            break
        step = min(chunk, gcfg.max_new_tokens - produced)
        with _no_grad(model), gathered(model):
            toks = _decode_steps(model, gcfg, state, step, generator)
            toks = toks.cpu().numpy()
        yield toks
        produced += step


def _all_done(done: torch.Tensor) -> bool:
    """Every row done, on every rank of an active parallel context (the
    ranks then stop at the same step)."""
    pctx = parallel_context()
    if pctx is None:
        return bool(done.all())
    import torch.distributed as dist

    flag = done.all().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def truncate_at_stops(gen: np.ndarray, gcfg: GenerationConfig) -> np.ndarray:
    """Pad everything from the first EOS token / stop sequence onward."""
    if not (gcfg.eos_token_ids or gcfg.stop_sequences):
        return gen
    out = np.full_like(gen, gcfg.pad_token_id)
    for bi in range(gen.shape[0]):
        row = gen[bi]
        end = row.shape[0]
        if gcfg.eos_token_ids:
            stop = np.isin(row, gcfg.eos_token_ids).nonzero()[0]
            if stop.size:
                end = int(stop[0])
        for seq in gcfg.stop_sequences:
            s = np.asarray(seq)
            for pos in range(0, end - len(s) + 1):
                if np.array_equal(row[pos:pos + len(s)], s):
                    end = pos
                    break
        out[bi, :end] = row[:end]
    return out


def decode_texts(tokenizer, gen_ids: np.ndarray, pad_token_id: int = 0,
                 skip_special_tokens: bool = True) -> Sequence[str]:
    texts = []
    for row in gen_ids:
        ids = [int(t) for t in row if int(t) != pad_token_id]
        texts.append(tokenizer.decode(ids, skip_special_tokens=skip_special_tokens))
    return texts
