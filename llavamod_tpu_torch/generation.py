"""Batched autoregressive generation with a static KV cache (port of
llavamod_tpu/generation.py).

One prefill (multimodal splice included) fills a preallocated cache of
`t + max_new_tokens` slots, then one decoder step per token; greedy or
temperature/top-k/top-p sampling; early stop via a done mask.  Everything
runs under torch.inference_mode().

Prompts must be LEFT-padded (segment 0 on the left) so every sequence's
next-token slot is the last position; positions are segment-aware so RoPE
sees 0 at each sequence's first real token.  The cache `length` is one
scalar shared by all rows; decode positions are prompt_len + i.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llm import decoder
from llavamod_tpu_torch.models.llava import Llava, MultimodalBatch


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


class _DecodeState:
    """What the decode loop carries from step to step."""

    def __init__(self, cache, tok, done, window, prompt_len):
        self.cache, self.tok, self.done = cache, tok, done
        self.window, self.prompt_len = window, prompt_len
        self.step = 0


def _prefill(model: Llava, batch: MultimodalBatch, gcfg: GenerationConfig,
             generator: Optional[torch.Generator]) -> _DecodeState:
    """Encode the multimodal prompt into a fresh cache and sample the first
    token."""
    cfg = model.cfg
    b, t = batch.input_ids.shape
    dev = batch.input_ids.device
    seg = batch.segment_ids
    positions = torch.clamp_min(torch.cumsum(seg, dim=1) - 1, 0)
    prompt_len = seg.sum(dim=1)
    cache = decoder.init_cache(cfg.llm, b, t + gcfg.max_new_tokens,
                               dtype=_CACHE_DTYPES[gcfg.cache_dtype],
                               device=dev)
    # attn_impl="fresh": the cache is empty, so prefill attention runs on the
    # chunk's own K/V (kernel K1 on the card) while the cache is written
    out = llava.forward(model, cfg, batch._replace(positions=positions),
                        cache=cache, train=False, attn_impl="fresh")
    last_logits = llava.logits(model, cfg, out.hidden[:, -1:])[:, 0]

    is_eos, push_window, window_stopped, win = _stop_machinery(gcfg, b, dev)
    first = _sample(last_logits, gcfg, generator)
    window = push_window(torch.full((b, win), -1, dtype=torch.int32,
                                    device=dev), first)
    done = is_eos(first) | window_stopped(window)
    return _DecodeState(out.cache, first, done, window, prompt_len)


def _decode_steps(model: Llava, gcfg: GenerationConfig, state: _DecodeState,
                  n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Decode `n` tokens from `state` (advanced in place).  Returns [B, n]."""
    cfg = model.cfg
    b = state.tok.shape[0]
    dev = state.tok.device
    is_eos, push_window, window_stopped, _ = _stop_machinery(gcfg, b, dev)
    ones = torch.ones((b, 1), dtype=torch.int32, device=dev)
    toks = []
    for _ in range(n):
        emb = decoder.embed(model.llm, cfg.llm, state.tok[:, None])
        dout = decoder.forward(model.llm, cfg.llm, inputs_embeds=emb,
                               positions=(state.prompt_len + state.step)[:, None],
                               segment_ids=ones, cache=state.cache, train=False)
        logits = llava.logits(model, cfg, dout.hidden[:, -1:])[:, 0]
        nxt = _sample(logits, gcfg, generator)
        nxt = torch.where(state.done, gcfg.pad_token_id, nxt).to(torch.int32)
        state.window = push_window(state.window, nxt)
        state.done = state.done | is_eos(nxt) | window_stopped(state.window)
        state.cache, state.tok = dout.cache, nxt
        state.step += 1
        toks.append(nxt)
    return torch.stack(toks, dim=1)


@torch.inference_mode()
def generate(model: Llava, batch: MultimodalBatch, gcfg: GenerationConfig,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Returns generated ids [B, max_new_tokens] (pad after EOS)."""
    state = _prefill(model, batch, gcfg, generator)
    parts = [state.tok[:, None]]
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
    with torch.inference_mode():
        state = _prefill(model, batch, gcfg, generator)
        first = state.tok.cpu().numpy()[:, None]
    yield first
    produced = 1
    while produced < gcfg.max_new_tokens:
        if bool(state.done.all()):
            break
        step = min(chunk, gcfg.max_new_tokens - produced)
        with torch.inference_mode():
            toks = _decode_steps(model, gcfg, state, step, generator)
            toks = toks.cpu().numpy()
        yield toks
        produced += step


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
