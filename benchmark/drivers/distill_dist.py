"""A distillation cell on several cards: stage 2b of the program's recipe
(`recipe` and `extra_flags` in the cell's file) under
`torch.distributed.run --nproc_per_node <chips>`, one worker process a
card, each running the program's own distributed path: the process group
(NCCL; gloo on the CPU), the mesh the recipe's flags ask for
(`_DeviceContext`), both models sharded (`shard_models`: FSDP2, the
experts split over `--expert_parallel`), its rows from the process-sharded
sampler, the align step under the parallel context.

benchmark/run.py's process writes the seeded conversations and JPEGs
under TMPDIR and launches the workers, which read them.  Each worker runs
the one-card driver's own pieces (benchmark/drivers/distill.py): `setup`
under the program's device context, which draws both models from the seed
and shards them; `first_update`, the first `accum` microbatches (one
optimizer update over the world's rows) and the one after through the
window's own call and feed (`feeder`); `window`, whole microbatches in
step on every rank until rank 0 reads `seconds` at a microbatch boundary;
with a trace, `traced_cycle` on every rank.  The workers write their
readings, with any module of the JAX stack each holds at its end, and
exit; this process then assembles the result (`assemble`, which refuses
the run where a rank held one) and, on its card, runs the reference over
the world's first update: each step one batch of the ranks' rows, in the
program's row order (`distill.reference_checks`, `rows`).

The program's readings, as the optimizer holds them: each step's loss
(the world's, as every rank reports it), the norm of every trainable
leaf's first gradient and of its accumulated mean (the ranks' shards
summed in square, each shard once), and of its change at the update (the
leaf gathered whole, against the seed's draw).

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        benchmark/drivers/distill_dist.py <run directory>

is how `run` starts the workers; the run directory holds `job.json`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmark.drivers import distill  # noqa: E402
from benchmark.harness import common, flops, program, traffic  # noqa: E402
from benchmark.harness import spans as sp  # noqa: E402
from benchmark.harness import weights as wmod  # noqa: E402
from benchmark.harness.tokenizer import StandInTokenizer  # noqa: E402
from benchmark.harness.trace import Summary  # noqa: E402
from benchmark.reference import checks as rchecks  # noqa: E402

# a run's whole budget is 1,200 s where it builds, 360 s otherwise; the
# workers get what is left of the first
WORKER_DEADLINE_S = 1100.0


def run(name: str, cell: dict, seed: int, seconds: float, trace: bool,
        device: str, t_proc: float, log=common.log, variants=(),
        launch=None) -> dict:
    """One run of the cell.  `variants` (benchmark/controls.py): as in
    benchmark/drivers/distill.py.  `launch(root, world, log, timeout)`
    starts the workers (default: torch.distributed.run)."""
    cfg_s, cfg_t = common.config(cell["config"]), common.config(cell["teacher"])
    mix = common.traffic(cell["traffic"])
    tok = StandInTokenizer()
    world = cell["chips"]
    root = tempfile.mkdtemp(prefix="bench-distill-dist-")
    try:
        data, folder, records, _ = traffic.write_conversations(
            mix, seed, tok, wmod.n_image(cfg_s), root)
        t_wall = time.time() - (time.perf_counter() - t_proc)
        job = dict(cell=cell, cfg_s=cfg_s, cfg_t=cfg_t, mix=mix, seed=seed,
                   seconds=seconds, trace=trace, device=device, data=data,
                   folder=folder)
        with open(os.path.join(root, "job.json"), "w") as f:
            json.dump(job, f)
        left = WORKER_DEADLINE_S - (time.perf_counter() - t_proc)
        (launch or torchrun)(root, world, log, left)
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        out = assemble(ranks, t_wall)
        log(f"[window] {out['attempted']} microbatches on {world} ranks, "
            f"{out['tokens']} real tokens in {out['ctx']['window_s']:.3f} s; "
            f"peak {out['memory_peak_bytes'] / 2 ** 30:.2f} GiB (fullest "
            f"card); mesh {ranks[0]['mesh']}")
        kw = dict(ranks[0]["ref_kw"], device=device, log=log)
        out.update(distill.reference_checks(
            cell, cfg_s, cfg_t, seed,
            distill.samples_of(out["order"], records, folder, tok),
            ranks[0]["readings"], tok, kw, world, log, variants))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def torchrun(root: str, world: int, log, timeout: float) -> None:
    """The workers under torch.distributed.run on this host, their output
    in <root>/workers.log (its end goes to the log); raises when any
    fails or the deadline passes (the whole group is ended then)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nnodes", "1", "--nproc_per_node", str(world),
           str(Path(__file__).resolve()), root]
    path = os.path.join(root, "workers.log")
    with open(path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=str(common.ROOT), start_new_session=True)
        try:
            rc = proc.wait(timeout=max(60.0, timeout))
        except subprocess.TimeoutExpired:
            rc = None
            for sig in (signal.SIGTERM, signal.SIGKILL):
                try:
                    os.killpg(proc.pid, sig)
                    proc.wait(timeout=30)
                    break
                except (ProcessLookupError, subprocess.TimeoutExpired):
                    continue
    with open(path) as f:
        lines = f.read().splitlines()
    for ln in lines[-(40 if rc == 0 else 200):]:
        log(f"[workers] {ln}")
    if rc != 0:
        raise RuntimeError(f"the workers failed (exit code {rc}; None: past "
                           f"the deadline of {timeout:.0f} s)")


def assemble(ranks: List[dict], t_wall: float) -> dict:
    """The run's result from the workers' readings (rank order): the
    world's real tokens over rank 0's window, set-up from the run's start
    to rank 0's window, the fullest card's peak, the per-layer context of
    rank 0 (its trace, spans, data waits, attention work) with the
    world's FLOPs shared out per card, the device's busy and window
    seconds averaged over the cards, and the world's first-update row
    order (each step the ranks' rows by row rank).  Raises where a rank
    held a module of the JAX stack once its work was done."""
    bad = {r["rank"]: r["forbidden"] for r in ranks if r["forbidden"]}
    if bad:
        raise RuntimeError(f"modules of the JAX stack are loaded in the "
                           f"workers (rank: modules): {bad}")
    r0, world = ranks[0], len(ranks)
    tokens = sum(r["tokens"] for r in ranks)
    window_s = r0["window_s"]
    peak = max(r["peak"] for r in ranks)
    fl: Dict[str, float] = {}
    for r in ranks:
        flops.add(fl, r["flops"], 1.0 / world)
    ctx = {"window_s": window_s, "flops": fl, "data_wait_s": r0["waits"],
           "trace": r0["trace"], "attn_least_s": r0["attn_least"],
           "memory_peak_bytes": peak, "spans": r0["spans"]}
    summary = None
    if r0["trace"] is not None:
        tr = [r["trace"] for r in ranks]
        summary = Summary(sum(t.window_s for t in tr) / world,
                          sum(t.busy_s for t in tr) / world,
                          r0["trace"].by_name, r0["trace"].gaps)
    by_row = sorted(ranks, key=lambda r: r["row_rank"])
    order = [r["order"][i] for i in range(len(r0["order"])) for r in by_row]
    return {
        "attempted": sum(r["microbatches"] for r in ranks), "failed": 0,
        "tokens": tokens,
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "setup_s": r0["t_window_wall"] - t_wall},
        "ctx": ctx, "memory_peak_bytes": peak, "trace": summary,
        "order": order,
    }


def first_update_order(cell: dict, cfg_s: dict, mix: dict, seed: int,
                       data: str, folder: str, tok) -> List[tuple]:
    """The record keys of the world's first update and the step after it,
    in the workers' row order, read in this process from the program's own
    loaders: one built as each rank builds it (its process-sharded sampler
    at the world's size), its shard set to the rank's."""
    from llavamod_tpu_torch.train import run as prun
    from llavamod_tpu_torch.train.loader import infinite_batches

    world = cell["chips"]
    margs, dargs, targs, _ = distill._parse(
        cell["recipe"], distill.recipe_env(cell, data, folder, ""),
        cell.get("extra_flags", ()))
    targs = dataclasses.replace(targs, seed=seed % 2 ** 31,
                                num_train_epochs=mix["epochs"])
    accum = max(1, targs.gradient_accumulation_steps)
    pcfg = program.llava_config(cfg_s)
    saved = os.environ.get("WORLD_SIZE")
    os.environ["WORLD_SIZE"] = str(world)
    try:
        per_rank = []
        for r in range(world):
            loader = prun.build_data_module("align", margs, dargs, targs, tok,
                                            pcfg)
            loader.sampler.rank = r
            host = infinite_batches(loader)
            per_rank.append([distill._record_key(next(host))
                             for _ in range(accum + 1)])
            host.close()
    finally:
        if saved is None:
            del os.environ["WORLD_SIZE"]
        else:
            os.environ["WORLD_SIZE"] = saved
    return [per_rank[r][i] for i in range(accum + 1) for r in range(world)]


def controls(cell: dict, seed: int, device: str, variants, log=common.log
             ) -> Dict[str, Dict[str, float]]:
    """The reference's variants (benchmark/controls.py: the control, the
    planted faults) over the world's first update, read on one card, each
    by the cell's numbers against the reference: {label: numbers}.  The
    rows are the workers' (`first_update_order`); the program's own
    numbers are the cell's runs' `checks`."""
    cfg_s, cfg_t = common.config(cell["config"]), common.config(cell["teacher"])
    mix = common.traffic(cell["traffic"])
    tok = StandInTokenizer()
    world = cell["chips"]
    root = tempfile.mkdtemp(prefix="bench-distill-dist-")
    try:
        data, folder, records, _ = traffic.write_conversations(
            mix, seed, tok, wmod.n_image(cfg_s), root)
        order = first_update_order(cell, cfg_s, mix, seed, data, folder, tok)
        samples = distill.samples_of(order, records, folder, tok)
        n = len(samples) - world
        margs, dargs, targs, salign = distill._parse(
            cell["recipe"], distill.recipe_env(cell, data, folder, ""),
            cell.get("extra_flags", ()))
        tcfg = _train_config(margs, targs, salign, mix, seed, world)
        kw = dict(distill.reference_settings(targs, tcfg, cfg_s, world),
                  device=device, log=log, rows=world)
        ref = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:n], tok,
                                     after=samples[n:], **kw)
        out = {}
        for label, extra in variants:
            v = rchecks.train_readings(cfg_s, cfg_t, seed, samples[:n], tok,
                                       after=samples[n:], **kw, **extra)
            out[label] = distill.numbers(v, ref)
            log(f"[{label}] " + ", ".join(f"{k} {x:.6g}"
                                          for k, x in out[label].items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _train_config(margs, targs, salign, mix, seed, world: int):
    """The program's train config as the workers build it (a rank's
    loader yields records / world / batch microbatches an epoch)."""
    from llavamod_tpu_torch.train import args as pargs
    from llavamod_tpu_torch.train import run as prun

    targs = dataclasses.replace(targs, seed=seed % 2 ** 31,
                                num_train_epochs=mix["epochs"])
    per_epoch = mix["records"] // world // targs.per_device_train_batch_size
    return pargs.train_config_from_args(
        "align", targs, int(per_epoch * targs.num_train_epochs),
        dataclasses.replace(margs, train_modules=prun.translate_train_modules(
            margs.train_modules)), salign)


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _leaf_norms(grads: Dict[str, torch.Tensor], weights: Dict[str, float]
                ) -> Dict[str, float]:
    """Each leaf's norm over the world from this rank's shards: the
    shards' squares, each weighted by the share of the world that holds
    the same shard (`Optimizer.norm_weights`), summed over the world."""
    from llavamod_tpu_torch.parallel.sharding import local_tensor

    names = sorted(grads)
    sq = torch.stack([local_tensor(grads[n]).float().pow(2).sum() * weights[n]
                      for n in names])
    torch.distributed.all_reduce(sq)
    return dict(zip(names, sq.sqrt().tolist()))


@torch.no_grad()
def _whole(name: str, p: torch.Tensor, pctx) -> torch.Tensor:
    """A sharded parameter gathered whole on every rank: over its FSDP2
    shards, and an expert tensor over the expert ranks."""
    from torch.distributed.tensor import DTensor

    from llavamod_tpu_torch.parallel.collectives import is_expert_key

    full = p.full_tensor() if isinstance(p, DTensor) else p.detach()
    if is_expert_key(name) and pctx.expert_size > 1:
        parts = [torch.empty_like(full) for _ in range(pctx.expert_size)]
        torch.distributed.all_gather(parts, full.contiguous(),
                                     group=pctx.expert_group)
        full = torch.cat(parts)
    return full


def worker(root: str) -> None:
    """One rank of the run in <root> (job.json): writes <root>/rank<r>.pt,
    which also names any module of the JAX stack that the rank holds once
    its work is done (`assemble` refuses the run then)."""
    from llavamod_tpu_torch.train import run as prun

    dist = torch.distributed
    with open(os.path.join(root, "job.json")) as f:
        job = json.load(f)
    cell, seed, cfg_s, cfg_t, mix = (job[k] for k in
                                     ("cell", "seed", "cfg_s", "cfg_t", "mix"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, _ = prun.init_distributed(job["device"])
    rank = dist.get_rank()
    cuda = dev.type == "cuda"
    if cuda and rank == 0:      # one build of the kernels, not one a rank
        from llavamod_tpu_torch import native
        from llavamod_tpu_torch.ops import cuda_build

        cuda_build.load_library()
        native.load_library()
    dist.barrier()
    log = common.log if rank == 0 else (lambda *a: None)
    tok = StandInTokenizer()
    tr = distill.setup(
        cell, cfg_s, cfg_t, mix, seed,
        distill.recipe_env(cell, job["data"], job["folder"],
                           os.path.join(root, "out")),
        tok, dev, log, mesh_of=lambda targs: prun._DeviceContext(targs, dev))
    pctx = tr.pctx
    microbatch, host = distill.feeder(tr, dev)
    weights = getattr(tr.state.opt, "inner", tr.state.opt).norm_weights
    tr.state, readings, order = distill.first_update(
        tr.state, microbatch, tr.accum, lambda g: _leaf_norms(g, weights),
        lambda params: distill.change_norms(
            params, cfg_s, seed, dev, whole=lambda n, p: _whole(n, p, pctx),
            keep=rank == 0))
    log(f"[setup] first update: {tr.accum} microbatches a rank and the one "
        f"after, world losses "
        f"{[round(x, 5) for x in readings['losses'] + [readings['loss_after']]]}, "
        f"optimizer updates {tr.state.opt.updates}")

    # the window: every rank stops at the microbatch where rank 0 reads
    # `seconds`
    flag = torch.zeros((), device=dev)

    def stop(elapsed: float) -> bool:
        if rank == 0:
            flag.fill_(float(elapsed >= job["seconds"]))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    dist.barrier()
    tr.state, win = distill.window(tr.state, microbatch, stop, cfg_s, cfg_t)
    summary, traced = None, []
    if job["trace"]:
        tr.state, summary, traced = distill.traced_cycle(tr.state, microbatch,
                                                         tr.accum)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    host.close()
    out = {"rank": rank, "row_rank": pctx.row_rank, "accum": tr.accum,
           "mesh": dataclasses.asdict(pctx.cfg), "order": order,
           "readings": readings, "microbatches": win["microbatches"],
           "tokens": win["tokens"], "window_s": win["window_s"],
           "t_window_wall": win["t_window_wall"], "waits": win["waits"],
           "flops": win["flops"], "trace": summary,
           "attn_least": distill.attention_least_s(cfg_s, cfg_t, traced),
           "peak": peak,
           "spans": sp.of({}) if job["trace"] else None,
           "ref_kw": distill.reference_settings(tr.targs, tr.tcfg, cfg_s,
                                                pctx.rows),
           "forbidden": common.forbidden_loaded()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1])
