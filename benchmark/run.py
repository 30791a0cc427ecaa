"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's file (benchmark/workloads/<name>.json) names its driver
(benchmark/drivers/<driver>.py), its configuration and its traffic mix;
the metrics it reports are those of BENCHMARK.json that list it (or list
no cells): its end-to-end metrics untraced, its per-layer metrics traced,
each read by benchmark/metrics/<metric>.py.  The last line of standard
output is the result; the comparisons that decide `correct` are the last
lines of standard error and the result's last key.  The run fails, and
prints no result, without a CUDA device, or when a JAX module is loaded
once the window has closed.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402


def read_metric(name: str, ctx: dict):
    """The value of benchmark/metrics/<name>.py's `read(ctx)`, or None."""
    path = common.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_env()
    # one process, few threads: the host launches the card's work
    os.environ.setdefault("OMP_NUM_THREADS", "1")

    import torch

    cell = common.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        common.log(f"[fail] the cell needs {cell['chips']} CUDA device(s); "
                   f"found {torch.cuda.device_count()}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = common.card_info()
    common.log(f"[card] {card}")
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    out = driver.run(args.workload, cell, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_PROC)
    bad = common.forbidden_loaded()
    if bad:
        common.log(f"[fail] modules of the JAX stack are loaded: {bad}")
        return 3
    metrics = {}
    for m in common.cell_metrics(args.workload, bool(args.trace)):
        if args.trace:
            value = read_metric(m["name"], out["ctx"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace and out["trace"] is not None:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    common.log(f"[card] power limit {card.get('power.limit', '?')}, "
               f"setup_s {out['end_to_end']['setup_s']}")
    common.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
