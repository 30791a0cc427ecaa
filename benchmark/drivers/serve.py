"""A serving cell: the program's `BatchingEngine` (serve/server.py) in
process, on a `VQARunner` around the benchmark's seeded model, driven by a
closed loop of client threads.

Each client does what the HTTP handler does after decoding a request: it
runs the runner's image preprocessor on its image, builds the prompt with
the runner's template, calls `submit`, and sends its next request when the
reply comes.  A request is timed from the moment its client began it to
its reply.  Set-up warms the engine with whole batches at the largest
answer budget.  The window starts every client at once and, at its close,
lets the requests in flight finish; the rate and the tail count the
requests completed inside it.  A traced run times each
`generation.generate` call, and profiles a run of whole batches that start
after the window, so that the profiler's cost stays out of it.  Afterwards the
program is freed and the reference scores a seeded sample of the finished
requests, the longest among them.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import List

import numpy as np
import torch

from benchmark.harness import common, flops, program, traffic
from benchmark.harness.tokenizer import StandInTokenizer, ids_of
from benchmark.harness.trace import Trace, span
from benchmark.reference import checks as rchecks

TRACE_BATCHES = 6
# the numbers a cell's limits may name, by the reference's keys
# (rchecks.serve_gaps); the control's are "control_" + the key
NUMBERS = {"widest_logit_gap": "gap", "mean_logit_gap": "mean_gap",
           "widest_untied_logit_gap": "untied_gap"}


def p95(values: List[float]) -> float:
    """The 95th percentile (nearest rank) of `values`."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(name: str, cell: dict, seed: int, seconds: float, trace: bool,
        device: str, t_proc: float, log=common.log, control: bool = False
        ) -> dict:
    """One run of the cell.  `control` (benchmark/controls.py only) also
    reads the lower precision's gap on the same sample."""
    from PIL import Image
    import llavamod_tpu_torch.generation as gen_mod
    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.models.builder import make_image_preprocessor
    from llavamod_tpu_torch.serve.server import BatchingEngine

    cfg = common.config(cell["config"])
    mix = common.traffic(cell["traffic"])
    eng = cell["engine"]
    tok = StandInTokenizer()
    t = time.perf_counter()
    pcfg, model = program.build(cfg, seed, "model", device, torch.bfloat16)
    log(f"[setup] model made on the device in {time.perf_counter() - t:.2f} s")
    runner = VQARunner(model=model, tokenizer=tok,
                       image_preprocessor=make_image_preprocessor(pcfg),
                       template_name=eng["template"],
                       max_prompt_len=eng["max_prompt_len"])
    engine = BatchingEngine(runner, max_batch=eng["max_batch"],
                            batch_window=eng["batch_window"],
                            default_max_new=max(mix["max_new_tokens"]),
                            temperature=0.0)
    raw = traffic.images(mix, seed)
    pil = [Image.fromarray(a) for a in raw]
    pool = traffic.questions(mix, seed)
    clients = mix["clients"]

    # a traced run times each generate call to its end on the card, and
    # profiles TRACE_BATCHES whole batches that start after the window
    spans: List[tuple] = []
    traced: List[tuple] = []
    tr = Trace() if trace else None
    summary = [None]
    close = [math.inf]
    traced_done = threading.Event()
    orig_generate = gen_mod.generate

    def timed_generate(model_, batch, gcfg, *a, **kw):
        t0 = time.perf_counter()
        profiling = t0 >= close[0] and len(traced) < TRACE_BATCHES
        if profiling and not traced:
            tr.start()
        with span("bench.generate"):
            out = orig_generate(model_, batch, gcfg, *a, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
        rec = (t0, time.perf_counter(),
               [int(x) for x in batch.segment_ids.sum(1).tolist()],
               gcfg.max_new_tokens)
        spans.append(rec)
        if profiling:
            traced.append(rec)
            if len(traced) == TRACE_BATCHES:
                summary[0] = tr.stop()
                traced_done.set()
        return out

    done: List[tuple] = []
    lock = threading.Lock()
    stop = threading.Event()

    def client(c: int, budget=None, once=False):
        j = c
        while not stop.is_set():
            r = pool[j % len(pool)]
            j += clients
            t0 = time.perf_counter()
            out, err = None, None
            try:
                with span("bench.client"):
                    img = runner.image_preprocessor(pil[r["image"]])
                    prompt = runner.build_prompt(r["question"], True)
                    out = engine.submit(prompt, img, budget or r["max_new_tokens"],
                                        timeout=eng["timeout_s"])
            except Exception as exc:  # noqa: BLE001 - a failed request counts
                err = f"{type(exc).__name__}: {exc}"
            with lock:
                done.append((t0, time.perf_counter(), r, out, err))
            if once:
                return

    # warm-up: whole batches at the largest answer budget
    for _ in range(eng["warm_batches"]):
        ths = [threading.Thread(target=client, args=(c, max(mix["max_new_tokens"]), True))
               for c in range(eng["max_batch"])]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    failed_warm = [d for d in done if d[4]]
    if failed_warm:
        raise RuntimeError(f"warm-up request failed: {failed_warm[0][4]}")
    done.clear()
    if trace:
        gen_mod.generate = timed_generate
        encode = runner._encode_batch

        def spanned_encode(*a, **kw):
            with span("bench.encode"):
                return encode(*a, **kw)

        runner._encode_batch = spanned_encode
    stats0 = engine.stats_snapshot()
    enc0 = runner.timings["encode"]

    t_win = time.perf_counter()
    setup_s = t_win - t_proc
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    time.sleep(max(0.0, t_win + seconds - time.perf_counter()))
    t_close = close[0] = time.perf_counter()
    stats1 = engine.stats_snapshot()
    enc1 = runner.timings["encode"]
    if trace:
        traced_done.wait(eng["timeout_s"] * (TRACE_BATCHES + 2))
    stop.set()
    for th in threads:
        th.join(eng["timeout_s"] + 60)
    gen_mod.generate = orig_generate
    window_s = t_close - t_win
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    engine.shutdown()

    inside = [d for d in done if d[1] <= t_close]
    ok = [d for d in inside if d[4] is None]
    failed = [d for d in done if d[4] is not None]
    lat = [(d[1] - d[0]) * 1e3 for d in ok] + [math.inf] * len(failed)
    fl = {}
    for d in ok:
        prompt = int(d[3]["usage"]["prompt_tokens"])
        flops.add(fl, flops.serve_request(cfg, prompt, d[2]["max_new_tokens"]))
    batches = stats1["batches"] - stats0["batches"]
    log(f"[window] {len(inside)} requests completed in {window_s:.3f} s "
        f"({len(failed)} failed), {batches} batches, peak "
        f"{peak / 2 ** 30:.2f} GiB")

    attn_least = 0.0
    for _, _, lengths, max_new in traced:
        for kind, ns in (("fwd", lengths),) + tuple(
                ("decode", [n + s for n in lengths]) for s in range(1, max_new)):
            f_, b_ = 0.0, 0.0
            for n in ns:
                w = flops.attention_work(cfg, n, kind)
                f_, b_ = f_ + w[0], b_ + w[1]
            attn_least += cfg["num_hidden_layers"] * flops.roofline_seconds(f_, b_)

    # the sample the reference scores: drawn from the seed, the longest in
    finished = [d for d in done if d[4] is None]
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    want = min(cell["check"]["requests"], len(finished))
    longest = max(range(len(finished)), key=lambda i: (
        finished[i][3]["usage"]["prompt_tokens"] + finished[i][2]["max_new_tokens"]))
    pick = [longest] + [int(i) for i in rng.permutation(len(finished))
                        if i != longest][:want - 1]
    sample = [(raw[finished[i][2]["image"]], finished[i][2]["question"],
               ids_of(finished[i][3]["text"]), finished[i][2]["max_new_tokens"])
              for i in pick]

    del engine, runner, model
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = rchecks.serve_gaps(cfg, seed, sample, tok, device,
                             pad_id=tok.pad_token_id, control=control,
                             near_tie=cell["check"].get("near_tie", 0.0),
                             log=log)
    log(f"[reference] {time.perf_counter() - t_ref:.1f} s")
    checks = [common.check(k, ref[NUMBERS[k]], lim)
              for k, lim in cell["limits"].items()]
    if ref["tokens"] < cell["check"]["min_tokens"]:
        checks.append(common.check("tokens_compared_short",
                                   float(cell["check"]["min_tokens"] - ref["tokens"]),
                                   0.0))
    rows = stats1["batched_rows"] - stats0["batched_rows"]
    return {
        "attempted": len(inside) + len([d for d in failed if d[1] > t_close]),
        "failed": len(failed),
        "end_to_end": {"serve_requests_per_s": len(ok) / window_s,
                       "serve_latency_p95_ms": p95(lat) if lat else None,
                       "setup_s": setup_s},
        "ctx": {"window_s": window_s, "flops": fl, "trace": summary[0],
                "attn_least_s": attn_least, "memory_peak_bytes": peak,
                "rows": rows, "batches": batches,
                "encode_s": enc1 - enc0,
                "generate_s": [s[1] - s[0] for s in spans if s[1] <= t_close]},
        "memory_peak_bytes": peak, "trace": summary[0], "checks": checks,
        "reference": ref,
    }
