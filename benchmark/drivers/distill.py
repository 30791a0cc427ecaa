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
    from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
    from llavamod_tpu_torch.train import args as pargs
    from llavamod_tpu_torch.train import run as prun
    from llavamod_tpu_torch.train.loader import infinite_batches
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

    cfg_s, cfg_t = common.config(cell["config"]), common.config(cell["teacher"])
    mix = common.traffic(cell["traffic"])
    tok = StandInTokenizer()
    root = tempfile.mkdtemp(prefix="bench-distill-")
    try:
        data, folder, records, _ = traffic.write_conversations(
            mix, seed, tok, wmod.n_image(cfg_s), root)
        env = {"JSON_FILE": data, "IMAGE_FOLDER": folder,
               "OUTPUT_DIR": os.path.join(root, "out"),
               "REF_MLLM": cell["teacher"], "POLICY_MLLM": cell["config"]}
        margs, dargs, targs, salign = _parse(cell["recipe"], env,
                                             cell.get("extra_flags", ()))
        targs = dataclasses.replace(targs, seed=seed % 2 ** 31,
                                    num_train_epochs=mix["epochs"])
        t = time.perf_counter()
        pcfg_s, model = program.build(cfg_s, seed, "student", device,
                                      torch.float32)
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
        state = TrainState.create(model, tcfg)
        step_fn = make_align_step(pcfg_s, pcfg_t, tcfg)
        accum = max(1, tcfg.grad_accum_steps)

        host = infinite_batches(loader)
        keys = collections.deque()

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
            with span("bench.step"):
                st, metrics = step_fn(st, teacher, batch_from_arrays(b, device=device))
                m = {k: float(v) for k, v in metrics.items()}
            return st, m, key, ntok, t1 - t0

        # the first update and the microbatch after it, through the
        # window's own call and feed; the optimizer's input is read once
        inner = getattr(state.opt, "inner", state.opt)
        mean_grad = {}

        def read_input(grads, update=inner.update):
            if not mean_grad:
                mean_grad.update((n, float(g.float().norm()))
                                 for n, g in grads.items())
            return update(grads)

        inner.update = read_input
        losses, order, first = [], [], {}
        for i in range(accum + 1):
            state, m, key, _, _ = microbatch(state)
            losses.append(m["loss"])
            order.append(key)
            if i == 0:
                acc = getattr(state.opt, "acc", None)
                grads = acc if acc is not None else {
                    n: p.grad for n, p in state.opt.params.items()}
                first = {n: float(g.float().norm()) for n, g in grads.items()}
            if i == accum - 1:
                params = state.opt.params
                change = {}
                with torch.no_grad():
                    for g, part in wmod.iter_groups(cfg_s, seed, "student",
                                                    device, torch.float32):
                        for n, t0 in part.items():
                            if n in params:
                                change[n] = float(
                                    (params[n].detach().float() - t0).norm())
                        del part
        del inner.update
        prog = {"losses": losses[:accum], "loss_after": losses[accum],
                "first_grad": first, "mean_grad": mean_grad, "change": change}
        updates = state.opt.updates
        log(f"[setup] first update: {accum} microbatches and the one after, "
            f"losses {[round(x, 5) for x in losses]}, optimizer updates "
            f"{updates}")

        # the window
        t_win = time.perf_counter()
        setup_s = t_win - t_proc
        mb, tokens, waits, fl = 0, 0, [], {}
        while True:
            state, m, key, ntok, wait = microbatch(state)
            mb += 1
            tokens += ntok
            waits.append(wait)
            flops.add(fl, flops.distill_microbatch(cfg_s, cfg_t, ntok))
            if time.perf_counter() - t_win >= seconds:
                break
        window_s = time.perf_counter() - t_win
        # a traced run profiles one more accumulation cycle after it
        summary, traced = None, []
        if trace:
            tr = Trace()
            tr.start()
            for _ in range(accum):
                state, _, _, ntok, _ = microbatch(state)
                traced.append(ntok)
            summary = tr.stop()
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        host.close()
        log(f"[window] {mb} microbatches, {tokens} real tokens in "
            f"{window_s:.3f} s; peak {peak / 2 ** 30:.2f} GiB")

        attn_least = 0.0
        for n in traced:
            for c, kinds in ((cfg_s, ("fwd", "bwd")), (cfg_t, ("fwd",))):
                for kind in kinds:
                    attn_least += c["num_hidden_layers"] * flops.roofline_seconds(
                        *flops.attention_work(c, n, kind))

        del state, model, teacher, step_fn, it, params, inner, acc, grads
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        # the reference, from the seed and the raw inputs
        by_key = {}
        for r in records:
            by_key[rchecks.conversation_text_ids(r, tok)] = r
        samples = []
        from PIL import Image

        missing = sum(1 for k in order if k not in by_key)
        for k in order:
            r = by_key.get(k)
            if r is not None:
                img = np.asarray(Image.open(os.path.join(folder, r["image"]))
                                 .convert("RGB"))
                samples.append((r, img))
        checks, variant_numbers, got = [], {}, {}
        if missing:
            log(f"[check] {missing} of the first {len(order)} microbatches "
                "match no record of the data set")
            checks.append(common.check("unknown_rows", float(missing), 0.0))
        else:
            kw = dict(max_len=targs.model_max_length,
                      cap_tokens=targs.model_max_length
                      * targs.per_device_train_batch_size,
                      lr=_first_lr(tcfg), b1=tcfg.adam_b1, b2=tcfg.adam_b2,
                      eps=tcfg.adam_eps, clip=tcfg.max_grad_norm,
                      aux_coef=cfg_s["moe"]["router_aux_loss_coef"],
                      device=device, log=log)
            t_ref = time.perf_counter()
            ref = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:accum],
                                         tok, after=samples[accum], **kw)
            log(f"[reference] {time.perf_counter() - t_ref:.1f} s")
            got = numbers(prog, ref)
            for key in ("first_grad", "mean_grad", "change"):
                g, leaf, skipped = rchecks.leaf_gaps(prog[key], ref[key])
                log(f"[check] {key} leaves: "
                    + rchecks.leaf_summary(prog[key], ref[key])
                    + f"; worst {leaf} ({skipped} left out)")
            log(f"[check] program losses {losses}, reference "
                f"{ref['losses'] + [ref['loss_after']]}")
            checks += [common.check(k, got[k], lim)
                       for k, lim in cell["limits"].items()]
            for label, extra in variants:
                v = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:accum],
                                           tok, after=samples[accum], **kw,
                                           **extra)
                variant_numbers[label] = numbers(v, ref)
                log(f"[{label}] " + ", ".join(
                    f"{k} {x:.6g}" for k, x in variant_numbers[label].items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "attempted": mb, "failed": 0,
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "setup_s": setup_s},
        "ctx": {"window_s": window_s, "flops": fl, "data_wait_s": waits,
                "trace": summary, "attn_least_s": attn_least,
                "memory_peak_bytes": peak},
        "memory_peak_bytes": peak, "trace": summary, "checks": checks,
        "readings": got, "variants": variant_numbers,
    }


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
