"""The readings that the limits of `correct` were set from (not run by
benchmark/run.py): the program's on many seeds, and the controls' and
planted faults' on some of them, all in one process.

    python3 benchmark/controls.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2] [--seconds 8] [--dump out.jsonl]

* a distillation cell: on each seed, a run of the cell (its set-up drives
  the first update and the microbatch after it; a window of one
  microbatch) and the reference, giving the program's numbers
  (benchmark/drivers/distill.py `numbers`); on a control seed the
  reference then follows the same microbatches, with the same settings
  from the recipe, in the control's precision (float8 e4m3 for the
  bfloat16 products, int4 for the W8A8 ones) and under each planted fault
  (half of each sequence out of the loss, half of the microbatches out of
  the accumulated mean, the update's sign flipped), read by the same
  numbers;
* a distillation cell on several cards (driver `distill_dist`): on one
  card, on each seed, the reference over the world's first update in the
  workers' row order, then the control and the planted faults, read by
  the same numbers; the program's own numbers are its runs' `checks`;
* a serving cell: on each seed, a run of the cell (the program serves its
  traffic for `--seconds`), then the reference's gaps of the served tokens
  (the lower readings) and, on a control seed, at the same positions,
  those of the tokens the control puts first (the upper readings).

Prints one JSON line per seed; `--dump` also writes each serving seed's
per-token [gap, control gap, router margin] there.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402

VARIANTS = (("control", {"low": True}),
            ("half_batch", {"fault": "half_batch"}),
            ("half_accum", {"fault": "half_accum"}),
            ("flipped_update", {"fault": "flipped_update"}))


def distill_controls(name: str, cell: dict, seed: int, device: str,
                     variants=VARIANTS, log=common.log) -> dict:
    """{"program": numbers, label: numbers of each variant}; "correct"
    holds the run's checks against the cell's limits."""
    from benchmark.drivers import distill

    out = distill.run(name, cell, seed, 0.0, False, device,
                      time.perf_counter(), log=log, variants=variants)
    return {"program": out["readings"], **out["variants"],
            "correct": all(c["ok"] for c in out["checks"])}


def serve_controls(name: str, cell: dict, seed: int, seconds: float,
                   device: str, control: bool, log=common.log) -> dict:
    from benchmark.drivers import serve

    res = serve.run(name, cell, seed, seconds, False, device,
                    time.perf_counter(), log=log, control=control)
    ref = res["reference"]
    out = {"program": {k: ref[v] for k, v in serve.NUMBERS.items()},
           "tokens": ref["tokens"], "near_ties": ref["near_ties"],
           "per_token": ref["per_token"],
           "correct": all(c["ok"] for c in res["checks"])}
    if control:
        out["control"] = {k: ref["control_" + v] for k, v in serve.NUMBERS.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the controls (all)")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    common.set_cache_env()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.workload(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = (set(seeds) if args.control_seeds is None
           else {int(s) for s in args.control_seeds.split(",")})
    for seed in seeds:
        t0 = time.perf_counter()
        if cell["driver"] == "distill":
            out = distill_controls(args.workload, cell, seed, args.device,
                                   VARIANTS if seed in ctl else ())
        elif cell["driver"] == "distill_dist":
            from benchmark.drivers import distill_dist

            out = distill_dist.controls(cell, seed, args.device, VARIANTS)
        else:
            out = serve_controls(args.workload, cell, seed, args.seconds,
                                 args.device, seed in ctl)
            per_token = out.pop("per_token")
            if args.dump:
                with open(args.dump, "a") as f:
                    f.write(json.dumps({"seed": seed, "per_token": per_token})
                            + "\n")
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
