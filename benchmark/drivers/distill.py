"""A distillation cell: stage-2b mimic distillation exactly as the program's
recipe (`recipe` in the cell's file) ships it, built with the program's
own functions around the benchmark's seeded models.

Set-up: the recipe's flags through the program's parser; seeded
conversations and JPEGs under TMPDIR; the student (float32 masters) and
the teacher (bfloat16, then W8A8 by `quantize_stage_models`) from the
benchmark's weights; the program's data module (its C++ preprocessor on
the loader's threads), train config, train state and align step; then the
first `accum` microbatches through the window's own call and feed, one
whole optimizer update, and the microbatch after it.  Their losses, the
first microbatch's gradient as the optimizer holds it, the accumulated
mean gradient as the optimizer gets it (read at its input, before the
clip), each trainable leaf's change at the update, and the loss of the
microbatch after it are the program's readings for the comparison.

Window: whole microbatches from its start until the first microbatch
boundary at or after `seconds`, updates included where they fall.  A
traced run profiles one more accumulation cycle after it, so that the
profiler's cost stays out of the window.  Afterwards the
program is freed and the reference (benchmark/reference) follows the same
`accum` microbatches from the seed.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import os
import shutil
import tempfile
import time
import types
from typing import Dict

import numpy as np
import torch

from benchmark.harness import common, flops, program, traffic
from benchmark.harness import weights as wmod
from benchmark.harness.tokenizer import StandInTokenizer
from benchmark.harness.trace import Trace, span
from benchmark.reference import checks as rchecks

def _parse(recipe: str, env: Dict[str, str], extra):
    from llavamod_tpu_torch.recipes import recipe_commands
    from llavamod_tpu_torch.train import args as pargs

    (_, argv), = recipe_commands(common.ROOT / recipe, env)
    classes = [pargs.ModelArgs, pargs.DataArgs, pargs.TrainArgs,
               pargs.AlignArgs]
    return pargs.parse_into_dataclasses(classes, argv + list(extra))


def _record_key(b) -> tuple:
    ids = np.asarray(b["input_ids"])[0]
    keep = (np.asarray(b["segment_ids"])[0] != 0) & ~np.asarray(b["image_mask"])[0]
    return tuple(int(i) for i in ids[keep])


def numbers(got: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of readings `got` against the reference's:
    the worst relative gap of the first update's losses and of the loss
    after it, and the worst leaf's gap of the norms of the first
    microbatch's gradient, of the accumulated mean gradient and of each
    leaf's change at the update (rchecks.leaf_gaps)."""
    return {
        "loss": max(abs(p - r) / abs(r)
                    for p, r in zip(got["losses"], ref["losses"])),
        "loss_after": abs(got["loss_after"] - ref["loss_after"])
        / abs(ref["loss_after"]),
        "first_grad": rchecks.leaf_gaps(got["first_grad"], ref["first_grad"])[0],
        "mean_grad": rchecks.leaf_gaps(got["mean_grad"], ref["mean_grad"])[0],
        "update": rchecks.leaf_gaps(got["change"], ref["change"])[0]}


def run(name: str, cell: dict, seed: int, seconds: float, trace: bool,
        device: str, t_proc: float, log=common.log, variants=()) -> dict:
    """One run of the cell.  `variants` (benchmark/controls.py only):
    [(label, train_readings keywords)] of reference runs (the control, the
    planted faults) read by the same numbers after the reference."""
    cfg_s, cfg_t = common.config(cell["config"]), common.config(cell["teacher"])
    mix = common.traffic(cell["traffic"])
    tok = StandInTokenizer()
    root = tempfile.mkdtemp(prefix="bench-distill-")
    try:
        data, folder, records, _ = traffic.write_conversations(
            mix, seed, tok, wmod.n_image(cfg_s), root)
        tr = setup(cell, cfg_s, cfg_t, mix, seed,
                   recipe_env(cell, data, folder, os.path.join(root, "out")),
                   tok, device, log)
        microbatch, host = feeder(tr, device)
        tr.state, prog, order = first_update(
            tr.state, microbatch, tr.accum, local_norms,
            lambda params: change_norms(params, cfg_s, seed, device))
        log(f"[setup] first update: {tr.accum} microbatches and the one "
            f"after, losses {[round(x, 5) for x in prog['losses'] + [prog['loss_after']]]}, "
            f"optimizer updates {tr.state.opt.updates}")

        tr.state, win = window(tr.state, microbatch,
                               lambda elapsed: elapsed >= seconds, cfg_s, cfg_t)
        setup_s = win["t_win"] - t_proc
        summary, traced = None, []
        if trace:
            tr.state, summary, traced = traced_cycle(tr.state, microbatch,
                                                     tr.accum)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        host.close()
        log(f"[window] {win['microbatches']} microbatches, {win['tokens']} "
            f"real tokens in {win['window_s']:.3f} s; peak "
            f"{peak / 2 ** 30:.2f} GiB")
        attn_least = attention_least_s(cfg_s, cfg_t, traced)
        kw = reference_settings(tr.targs, tr.tcfg, cfg_s)
        del tr, microbatch, host
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        # the reference, from the seed and the raw inputs
        ref = reference_checks(cell, cfg_s, cfg_t, seed,
                               samples_of(order, records, folder, tok), prog,
                               tok, dict(kw, device=device, log=log), 1, log,
                               variants)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "attempted": win["microbatches"], "failed": 0,
        "end_to_end": {"train_tokens_per_s": win["tokens"] / win["window_s"],
                       "setup_s": setup_s},
        "ctx": {"window_s": win["window_s"], "flops": win["flops"],
                "data_wait_s": win["waits"], "trace": summary,
                "attn_least_s": attn_least, "memory_peak_bytes": peak},
        "memory_peak_bytes": peak, "trace": summary, **ref,
    }


# ---------------------------------------------------------------------------
# the program's training as a cell drives it, on one card or as one rank of
# several (benchmark/drivers/distill_dist.py)
# ---------------------------------------------------------------------------

def recipe_env(cell: dict, data: str, folder: str, out_dir: str
               ) -> Dict[str, str]:
    """The recipe's variables: the data, the images, the output, the
    models."""
    return {"JSON_FILE": data, "IMAGE_FOLDER": folder, "OUTPUT_DIR": out_dir,
            "REF_MLLM": cell["teacher"], "POLICY_MLLM": cell["config"]}


def setup(cell: dict, cfg_s: dict, cfg_t: dict, mix: dict, seed: int,
          env: Dict[str, str], tok, device, log, mesh_of=None
          ) -> types.SimpleNamespace:
    """The recipe's flags through the program's parser, then its stage 2b
    as the recipe builds it around the benchmark's seeded models: the
    student (float32 masters) and the teacher (bfloat16, then W8A8 by
    `quantize_stage_models`), the data module (its C++ preprocessor on the
    loader's threads), the train config, the train state and the align
    step.  `mesh_of(targs)` (a rank of several): the program's device
    context, made before the models, which shards them and the state.
    Returns them as a namespace (`pctx` None on one card)."""
    from llavamod_tpu_torch.train import args as pargs
    from llavamod_tpu_torch.train import run as prun
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.steps import make_align_step

    margs, dargs, targs, salign = _parse(cell["recipe"], env,
                                         cell.get("extra_flags", ()))
    targs = dataclasses.replace(targs, seed=seed % 2 ** 31,
                                num_train_epochs=mix["epochs"])
    mesh = mesh_of(targs) if mesh_of is not None else None
    t = time.perf_counter()
    pcfg_s, model = program.build(cfg_s, seed, "student", device, torch.float32)
    pcfg_t, teacher = program.build(cfg_t, seed, "teacher", device,
                                    torch.bfloat16, vision=False)
    teacher.requires_grad_(False)
    log(f"[setup] models made on the device in {time.perf_counter() - t:.2f} s")
    loader = prun.build_data_module("align", margs, dargs, targs, tok, pcfg_s)
    total = int(len(loader) * targs.num_train_epochs)
    tcfg = pargs.train_config_from_args(
        "align", targs, total, dataclasses.replace(
            margs, train_modules=prun.translate_train_modules(
                margs.train_modules)), salign)
    prun.quantize_stage_models(tcfg, salign, model, teacher)
    pctx = None
    if mesh is not None:
        mesh.shard_models(model, teacher, tcfg)
        pctx = mesh.pctx
    state = TrainState.create(model, tcfg, pctx=pctx)
    return types.SimpleNamespace(
        targs=targs, tcfg=tcfg, loader=loader, teacher=teacher, state=state,
        step_fn=make_align_step(pcfg_s, pcfg_t, tcfg),
        accum=max(1, tcfg.grad_accum_steps), pctx=pctx)


def feeder(tr: types.SimpleNamespace, device):
    """The window's call and feed: (microbatch, host).  `microbatch(state)`
    takes the next batch from the program's prefetcher over its loader and
    runs the align step on it (under the parallel context, if any):
    (state, the step's metrics, the batch's record key, its real tokens,
    the seconds waited for it).  Close `host` when done."""
    from llavamod_tpu_torch.parallel.collectives import active
    from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
    from llavamod_tpu_torch.train.loader import infinite_batches
    from llavamod_tpu_torch.train.steps import batch_from_arrays

    host = infinite_batches(tr.loader)
    keys = collections.deque()
    step_fn, teacher, pctx = tr.step_fn, tr.teacher, tr.pctx

    def feed():
        for b in host:
            keys.append((_record_key(b),
                         int((np.asarray(b["segment_ids"]) != 0).sum())))
            yield b

    it = iter(DevicePrefetcher(feed(), device=device))

    def microbatch(st):
        t0 = time.perf_counter()
        with span("bench.data_wait"):
            b = next(it)
        t1 = time.perf_counter()
        key, ntok = keys.popleft()
        with span("bench.step"), active(pctx):
            st, metrics = step_fn(st, teacher, batch_from_arrays(b, device=device))
            m = {k: float(v) for k, v in metrics.items()}
        return st, m, key, ntok, t1 - t0

    return microbatch, host


def local_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm, on one card."""
    return {n: float(g.float().norm()) for n, g in grads.items()}


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor], cfg_s: dict, seed: int,
                 device, whole=None, keep: bool = True) -> Dict[str, float]:
    """Each trainable leaf's norm of change against the seed's draw, group
    by group.  `whole(name, p)`: the leaf gathered whole, where it is
    sharded (every rank calls it); only where `keep` is the draw made and
    the change read."""
    change = {}
    for g, entries in wmod.groups(cfg_s).items():
        names = [e[0] for e in entries if e[0] in params]
        if not names:
            continue
        init = (wmod.make_group(entries, seed, "student", g, device,
                                torch.float32) if keep else {})
        for n in names:
            p = whole(n, params[n]) if whole is not None else params[n].detach()
            if keep:
                change[n] = float((p.float() - init[n]).norm())
        del init
    return change


def first_update(state, microbatch, accum: int, norms, change):
    """The first `accum` microbatches (one whole optimizer update) and the
    one after, through the window's own call and feed: (state, the
    program's readings, the record keys in order).  The readings: the
    losses of the update's microbatches and of the one after, `norms` of
    the first microbatch's gradient as the optimizer holds it and of the
    accumulated mean as the optimizer gets it (read once at its input,
    before the clip), and `change(params)` after the update."""
    inner = getattr(state.opt, "inner", state.opt)
    mean_grad: Dict[str, float] = {}

    def read_input(grads, update=inner.update):
        if not mean_grad:
            mean_grad.update(norms(grads))
        return update(grads)

    inner.update = read_input
    losses, order, first, change_of = [], [], {}, {}
    for i in range(accum + 1):
        state, m, key, _, _ = microbatch(state)
        losses.append(m["loss"])
        order.append(key)
        if i == 0:
            acc = getattr(state.opt, "acc", None)
            first = norms(acc if acc is not None else {
                n: p.grad for n, p in state.opt.params.items()})
        if i == accum - 1:
            change_of = change(state.opt.params)
    del inner.update
    return state, {"losses": losses[:accum], "loss_after": losses[accum],
                   "first_grad": first, "mean_grad": mean_grad,
                   "change": change_of}, order


def window(state, microbatch, stop, cfg_s: dict, cfg_t: dict):
    """Whole microbatches from the window's start until `stop(seconds
    since the start)` holds at a microbatch boundary, updates included
    where they fall: (state, {t_win, t_window_wall, window_s,
    microbatches, tokens, waits, flops})."""
    t_win, t_wall = time.perf_counter(), time.time()
    mb, tokens, waits, fl = 0, 0, [], {}
    while True:
        state, _, _, ntok, wait = microbatch(state)
        mb += 1
        tokens += ntok
        waits.append(wait)
        flops.add(fl, flops.distill_microbatch(cfg_s, cfg_t, ntok))
        if stop(time.perf_counter() - t_win):
            break
    return state, {"t_win": t_win, "t_window_wall": t_wall,
                   "window_s": time.perf_counter() - t_win,
                   "microbatches": mb, "tokens": tokens, "waits": waits,
                   "flops": fl}


def traced_cycle(state, microbatch, accum: int):
    """One accumulation cycle under the profiler, after the window, so that
    its cost stays out of it: (state, the trace's summary, the traced
    microbatches' real tokens)."""
    tr = Trace()
    tr.start()
    traced = []
    for _ in range(accum):
        state, _, _, ntok, _ = microbatch(state)
        traced.append(ntok)
    return state, tr.stop(), traced


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def samples_of(order, records, folder: str, tok) -> list:
    """[(record, image uint8)] in `order` (record keys); None for a key
    that matches no record."""
    from PIL import Image

    by_key = {rchecks.conversation_text_ids(r, tok): r for r in records}
    out = []
    for k in order:
        r = by_key.get(tuple(k))
        out.append(None if r is None else (r, np.asarray(
            Image.open(os.path.join(folder, r["image"])).convert("RGB"))))
    return out


def reference_checks(cell: dict, cfg_s: dict, cfg_t: dict, seed: int,
                     samples: list, prog: dict, tok, kw: dict, rows: int,
                     log, variants=()) -> dict:
    """The reference over the first update's samples, `rows` to a step
    (one from each rank, in the program's row order), and the step after
    it; the cell's comparisons of the program's readings `prog` with it
    (`numbers`), and the variants' (benchmark/controls.py):
    {"checks", "readings", "variants"}."""
    missing = sum(1 for s in samples if s is None)
    if missing:
        log(f"[check] {missing} of the first {len(samples)} rows match no "
            "record of the data set")
        return {"checks": [common.check("unknown_rows", float(missing), 0.0)],
                "readings": {}, "variants": {}}
    n = len(prog["losses"]) * rows
    after = samples[n] if rows == 1 else samples[n:n + rows]
    kw = dict(kw, rows=rows)
    t_ref = time.perf_counter()
    ref = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:n], tok,
                                 after=after, **kw)
    log(f"[reference] {time.perf_counter() - t_ref:.1f} s")
    got = numbers(prog, ref)
    for key in ("first_grad", "mean_grad", "change"):
        g, leaf, skipped = rchecks.leaf_gaps(prog[key], ref[key])
        log(f"[check] {key} leaves: "
            + rchecks.leaf_summary(prog[key], ref[key])
            + f"; worst {leaf} ({skipped} left out)")
    log(f"[check] program losses {prog['losses'] + [prog['loss_after']]}, "
        f"reference {ref['losses'] + [ref['loss_after']]}")
    checks = [common.check(k, got[k], lim) for k, lim in cell["limits"].items()]
    out = {}
    for label, extra in variants:
        v = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:n], tok,
                                   after=after, **kw, **extra)
        out[label] = numbers(v, ref)
        log(f"[{label}] " + ", ".join(f"{k} {x:.6g}"
                                      for k, x in out[label].items()))
    return {"checks": checks, "readings": got, "variants": out}


def attention_least_s(cfg_s: dict, cfg_t: dict, traced) -> float:
    """The roofline's least seconds of the attention work of the traced
    microbatches (their real token counts): the student's forward and
    backward and the teacher's forward, every layer."""
    least = 0.0
    for n in traced:
        for c, kinds in ((cfg_s, ("fwd", "bwd")), (cfg_t, ("fwd",))):
            for kind in kinds:
                least += c["num_hidden_layers"] * flops.roofline_seconds(
                    *flops.attention_work(c, n, kind))
    return least


def reference_settings(targs, tcfg, cfg_s: dict, rows: int = 1) -> dict:
    """The reference's settings of the first update: the sequence length,
    the tokens the sparse layers' capacity counts (the slots of a batch of
    `rows` ranks' microbatches), the first learning rate, AdamW's and the
    clip's, the router loss's weight."""
    return dict(max_len=targs.model_max_length,
                cap_tokens=targs.model_max_length
                * targs.per_device_train_batch_size * rows,
                lr=_first_lr(tcfg), b1=tcfg.adam_b1, b2=tcfg.adam_b2,
                eps=tcfg.adam_eps, clip=tcfg.max_grad_norm,
                aux_coef=cfg_s["moe"]["router_aux_loss_coef"])


def _first_lr(tcfg) -> float:
    """The learning rate of the first update: the recipe's cosine schedule
    with its linear warm-up from 0 over int(updates x warmup_ratio)
    updates."""
    warmup = int(tcfg.total_steps * tcfg.warmup_ratio)
    if warmup > 0:
        return 0.0
    if tcfg.lr_schedule == "cosine":
        return tcfg.learning_rate * 0.5 * (1.0 + math.cos(0.0))
    return tcfg.learning_rate
