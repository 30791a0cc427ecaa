"""GPipe pipeline parallelism over the mesh's pipe axis (port of
llavamod_tpu/parallel/pipeline.py).

Each of the P stages (the ranks along pipe) keeps a contiguous block of
the decoder's layer repeats (`keep_stage_layers`, called by
parallel/sharding.py `shard_params`); a repeat is one structural period of
the layer kinds (`_layer_period`: 2 for the every-2nd-layer MoE), and the
repeat count must divide by P.  Under pipe > 1 `pipeline_layers` takes the
place of the decoder's layer loop (models/llm/decoder.py `forward`, the
no-cache path with `scan_layers`, as in the JAX package): the batch is cut
into M microbatches (`pipeline_microbatches`, or P when it is 0) and each
stage, microbatch by microbatch, takes the activation of the stage before
(stage 0: the microbatch's rows of the embedded input), runs its layers and
sends the result on; the last stage banks the outputs, which are then
handed to every stage, so that the final norm, the head and the loss run
unchanged on each.  This is the JAX package's tick schedule: stage s works
on microbatch t - s at tick t of M + P - 1, the same (P - 1) / (M + P - 1)
bubble; a stage idles in its bubble ticks where the JAX stages compute on
zeros and mask the result.

The backward is the reverse pipeline, driven by the same explicit loop
(`_Pipeline.backward`), never by autograd's traversal, so that the stages'
point-to-point transfers happen in the same order on every stage: for each
microbatch from the last, the stage takes the cotangent of its output (the
last stage from its own tail, the others from the stage after), runs the
backward of that microbatch's layers and sends the cotangent of its input
to the stage before.  The gradients therefore follow one rule:

  * a stage's layers take the gradients of their own microbatches only
    (they live on that stage alone);
  * every stage computes the tail (final norm, head, loss) whole on the
    same handed-off hidden states, so a tail parameter's gradient is whole
    and the same on every stage; the parameters before the layers
    (embedding, projector) reach the pipeline through stage 0 alone.  The
    gradient of every parameter outside the layers is therefore stage 0's,
    which `replicated_grads` hands to every stage (train/steps.py), and the
    replicated parameters stay equal over the pipe ranks.

The MoE aux loss sums over the layers and the microbatches and divides by
M.  Gating groups see one microbatch at a time (DeepSpeed's per-rank
semantics, as in the JAX pipeline): the result is the sequential one when
`moe_gating_group_size` divides the microbatch's token count, and the JAX
pipelined program's otherwise.  Router probes are not returned (the
decoder returns empty `moe_losses` / `router_probs`).  Remat recomputes
each layer of the stage with the policy of the un-pipelined loop.  The
data, fsdp, expert and tensor axes run inside each stage as they do
without pipe: the ranks of a stage hold the same microbatch at the same
time.  The JAX package's TPU workarounds (the canonicalised shard_map
boundary, the f32 input buffer and the f32 masked psum) have no
counterpart here.

The decoder's other calls, with a KV cache (generation) or with
`scan_layers` off (the gating dump), run un-pipelined in the JAX package:
its layer loop over the whole batch, the layers gathered by GSPMD.  Here a
stage holds only its layers, so `sequential_layers` runs the same loop as
the stages in turn on the whole batch, one microbatch (the schedule above
with M = 1): stage 0 runs its layers on the embedded input and sends the
result on, each later stage receives, runs its layers and sends on, and
the last stage's output goes to every stage.  The layers keep their global
indices (the sliding-window phase and MoE membership follow them), while a
stage's KV cache holds its own layers only (`init_cache` under pipe > 1:
slot `layer_idx - block.start`, `KVCache.first_layer`); the cache's
segment row and length are written before the layers, alike on every
stage.  Gating sees the whole batch, as in the JAX loop.  Each stage
collects the moe losses and router probes of its MoE layers, and every
stage returns them all in layer order (each stage's broadcast over the
pipe group; every stage holds the same number of MoE layers, on the same
tokens).  The aux loss is the pipe sum of the stages' sums.  Under
autograd (`scan_layers` off in training) the loop is the same autograd
node with M = 1, so the backward is the explicit reverse schedule and
`replicated_grads` applies unchanged; the probes are returned detached and
only the aux loss carries a gradient.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import torch
from torch import nn

from llavamod_tpu_torch.parallel.collectives import current

_STAGE_KEY = re.compile(r"(^|\.)llm\.layers\.\d+\.")


def pipe_size() -> int:
    """The pipe axis of the active parallel context (1 without one)."""
    pctx = current()
    return 1 if pctx is None else pctx.pipe_size


def _layer_kind(cfg, i: int):
    """Structural signature of layer i: (is_moe, sliding-window phase)."""
    is_moe = cfg.is_moe and (i in cfg.moe_layers)
    phase = i % cfg.sliding_window_pattern if cfg.sliding_window else 0
    return (is_moe, phase)


def _layer_period(cfg) -> int:
    """Smallest period p such that layer kinds repeat with period p."""
    kinds = [_layer_kind(cfg, i) for i in range(cfg.num_layers)]
    for p in range(1, cfg.num_layers + 1):
        if cfg.num_layers % p == 0 and all(
                kinds[i] == kinds[i % p] for i in range(cfg.num_layers)):
            return p
    return cfg.num_layers


def stage_block(cfg, pipe: int, stage: int) -> range:
    """The global indices of the layers stage `stage` of `pipe` keeps: a
    contiguous block of repeats / pipe layer repeats."""
    period = _layer_period(cfg)
    reps = cfg.num_layers // period
    if reps % pipe:
        raise ValueError(f"{reps} layer repeats not divisible by pipe={pipe}")
    n = reps // pipe * period
    return range(stage * n, (stage + 1) * n)


def is_stage_key(name: str) -> bool:
    """A state-dict key of a decoder layer of a Llava ('llm.layers.3.…',
    also under a prefix such as the adapters' 'lora.'): a tensor that lives
    on one pipeline stage only."""
    return _STAGE_KEY.search(name) is not None


class StageLayers(nn.ModuleList):
    """The decoder layers one pipeline stage keeps, registered under their
    global indices, so that the state-dict keys are the whole model's
    ('llm.layers.12.attn.wq' on the second of two stages of 24 layers).
    Iteration and positional indexing run over the stage's layers;
    `indices` holds their global indices."""

    def __init__(self, layers: Sequence[nn.Module], indices: Sequence[int]):
        super().__init__()
        for i, layer in zip(indices, layers):
            self.add_module(str(i), layer)
        self.indices: List[int] = list(indices)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


def keep_stage_layers(llm: nn.Module, pipe: int, stage: int) -> None:
    """Keep, in place, only the layers of stage `stage` of the decoder
    `llm` (its `cfg`)."""
    block = stage_block(llm.cfg, pipe, stage)
    layers = list(llm.layers)
    llm.layers = StageLayers([layers[i] for i in block], block)


class _Schedule:
    """One pipelined call of a stage's layers: the forward schedule and,
    for a call under autograd, the microbatches' graphs and the reverse
    schedule."""

    def __init__(self, cfg, layers: StageLayers, pctx, m: int, positions,
                 segment_ids, prefix_mask, train: bool, attn_impl: str,
                 remat: bool, cache=None):
        self.cfg, self.layers, self.pctx, self.m = cfg, layers, pctx, m
        self.extra = (positions, segment_ids, prefix_mask)
        self.train, self.attn_impl, self.remat = train, attn_impl, remat
        self.cache = cache
        self.saved: list = []
        # (moe loss, router probs) of the stage's MoE layers, detached
        self.probes: list = []

    def _stage(self, x: torch.Tensor, i: int, bm: int):
        """Microbatch i's activation `x` through the stage's layers:
        (output in x's dtype, the layers' aux sum)."""
        from torch.utils.checkpoint import checkpoint

        from llavamod_tpu_torch.models.llm.decoder import dots_saved_context

        rows = slice(i * bm, (i + 1) * bm)
        pos, seg, pfx = (None if a is None else a[rows] for a in self.extra)
        io_dtype = x.dtype
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for idx, layer in zip(self.layers.indices, self.layers):
            args = (self.cfg, x, pos, seg, idx, self.cache, self.train,
                    self.attn_impl, pfx)
            if self.remat:
                kw = ({"context_fn": dots_saved_context}
                      if self.cfg.remat_policy == "dots" else {})
                x, a, probs = checkpoint(layer, *args, use_reentrant=False,
                                         **kw)
            else:
                x, a, probs = layer(*args)
            aux = aux + a
            if probs is not None:
                self.probes.append((a.detach(), probs.detach()))
        return x.to(io_dtype), aux

    def forward(self, x: torch.Tensor):
        """(the last stage's banked outputs [B, ...] on every stage, the
        aux loss: the sum over the stages' layers and the microbatches,
        divided by M)."""
        pctx, m = self.pctx, self.m
        stage, last = pctx.pipe_rank, pctx.pipe_size - 1
        bm = x.shape[0] // m
        shape = (bm,) + tuple(x.shape[1:])
        grad = torch.is_grad_enabled()
        banked = []
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(m):
            inp = (x[i * bm:(i + 1) * bm] if stage == 0 else
                   pctx.recv_stage(shape, x.dtype, x.device, stage - 1))
            if grad:
                inp = inp.detach().requires_grad_(True)
            out, aux = self._stage(inp, i, bm)
            if stage < last:
                pctx.send_stage(out, stage + 1)
            else:
                banked.append(out.detach())
            if grad:
                self.saved.append((inp, out, aux))
            aux_sum = aux_sum + aux.detach()
        hidden = (torch.cat(banked) if stage == last
                  else x.new_empty(x.shape))
        hidden = pctx.broadcast_stage(hidden.contiguous(), last)
        return hidden, pctx.pipe_sum(aux_sum) / m

    def backward(self, g_hidden: torch.Tensor, g_aux: torch.Tensor
                 ) -> Optional[torch.Tensor]:
        """The reverse schedule; returns the cotangent of the embedded input
        on stage 0 (None on the others, whose input fed no stage)."""
        pctx, m = self.pctx, self.m
        stage, last = pctx.pipe_rank, pctx.pipe_size - 1
        bm = g_hidden.shape[0] // m
        g_in: list = [None] * m
        for i in reversed(range(m)):
            inp, out, aux = self.saved[i]
            g = (g_hidden[i * bm:(i + 1) * bm] if stage == last else
                 pctx.recv_stage(out.shape, out.dtype, out.device, stage + 1))
            outs, grads = [out], [g.to(out.dtype)]
            if aux.requires_grad:
                outs.append(aux)
                grads.append(g_aux.to(aux.dtype) / m)
            torch.autograd.backward(outs, grads)
            gi = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if stage > 0:
                pctx.send_stage(gi, stage - 1)
            else:
                g_in[i] = gi
            self.saved[i] = None
        return torch.cat(g_in) if stage == 0 else None


class _Pipeline(torch.autograd.Function):
    """The pipelined layers as one autograd node: its forward runs the
    forward schedule, building each microbatch's graph; its backward runs
    the reverse schedule.  `anchor` (a scalar that requires grad) makes the
    node part of every stage's graph, so that the backward reaches each
    stage whatever its input requires."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, anchor):
        with torch.enable_grad():
            hidden, aux = sched.forward(x)
        ctx.sched = sched
        return hidden, aux

    @staticmethod
    def backward(ctx, g_hidden, g_aux):
        g_x = ctx.sched.backward(g_hidden, g_aux)
        ctx.sched = None
        return None, g_x, None


def pipeline_layers(cfg, layers: StageLayers, x: torch.Tensor, positions,
                    segment_ids, train: bool, attn_impl: str, remat: bool,
                    prefix_mask: Optional[torch.Tensor] = None):
    """Run the decoder layer stack as a GPipe microbatch pipeline over the
    active context's pipe group; `layers` are this stage's.  Same contract
    as the layer loop of models/llm/decoder.py `forward`: returns (x_out
    [B, T, D] on every stage, aux_total scalar)."""
    pctx = current()
    b = x.shape[0]
    m = cfg.pipeline_microbatches or pctx.pipe_size
    if b % m:
        raise ValueError(
            f"batch {b} not divisible into {m} microbatches "
            f"(set pipeline_microbatches to a divisor of the batch)")
    sched = _Schedule(cfg, layers, pctx, m, positions, segment_ids,
                      prefix_mask, train, attn_impl,
                      remat and torch.is_grad_enabled())
    return _run(sched, x)


def _run(sched: _Schedule, x: torch.Tensor):
    """The schedule's forward: as one autograd node under autograd."""
    if not torch.is_grad_enabled():
        return sched.forward(x)
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    return _Pipeline.apply(sched, x, anchor)


def sequential_layers(cfg, layers: StageLayers, x: torch.Tensor, positions,
                      segment_ids, cache, train: bool, attn_impl: str,
                      remat: bool, prefix_mask: Optional[torch.Tensor] = None):
    """The un-pipelined layer loop under pipe > 1 (a KV cache, or
    `scan_layers` off): the stages in turn on the whole batch, each on its
    own cache slots (see the module docstring); `remat` as the decoder's
    loop decides it (no cache, under autograd).  Returns (x_out [B, T, D]
    on every stage, aux_total, moe_losses, router_probs), the last two in
    global layer order on every stage, as the single process's loop."""
    pctx = current()
    sched = _Schedule(cfg, layers, pctx, 1, positions, segment_ids,
                      prefix_mask, train, attn_impl, remat, cache)
    x, aux_total = _run(sched, x)
    losses, probs = [], []
    mine = sched.probes
    if mine:
        # every stage holds as many MoE layers, gated on the same tokens
        k, (n, e) = len(mine), mine[0][1].shape
        for stage in range(pctx.pipe_size):
            if stage == pctx.pipe_rank:
                flat = torch.cat([torch.stack([a.float() for a, _ in mine]),
                                  torch.cat([p.float().reshape(-1)
                                             for _, p in mine])])
            else:
                flat = x.new_empty((k + k * n * e,), dtype=torch.float32)
            flat = pctx.broadcast_stage(flat, stage)
            losses.extend(flat[:k].unbind())
            probs.extend(flat[k:].view(k, n, e).unbind())
    return x, aux_total, tuple(losses), tuple(probs)


@torch.no_grad()
def replicated_grads(grads, pctx) -> None:
    """Hand stage 0's gradients of the parameters outside the decoder
    layers (`grads`: {state-dict key: gradient, or its FSDP2 shard}) to
    every stage, in place, in one broadcast over the pipe group."""
    from llavamod_tpu_torch.parallel.sharding import local_tensor

    if pctx is None or pctx.pipe_size == 1:
        return
    local = [local_tensor(g) for n, g in grads.items()
             if not is_stage_key(n)]
    if not local:
        return
    flat = torch.cat([g.detach().float().reshape(-1) for g in local])
    pctx.broadcast_stage(flat, 0)
    at = 0
    for g in local:
        n = g.numel()
        g.copy_(flat[at:at + n].view(g.shape))
        at += n
