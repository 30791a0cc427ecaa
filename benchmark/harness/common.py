"""What every run shares: the checkout's paths, the cache directories, the
files a cell is made of (found by name), the card's description, the check
that no JAX module is loaded, and the result line.

The caches live inside the checkout at fixed paths (`build/`), so only the
first run of a cell in a checkout builds: the program builds its CUDA
kernels and its C++ image preprocessor into `build/llavamod_tpu_torch/`
beside its package, and Triton, if anything loads it, caches in
`build/triton/` (and `torch.utils.cpp_extension` in
`build/torch_extensions/`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# module names (the part before the first dot, compared whole) that no
# run may hold: the JAX stack and the JAX package the program was ported
# from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "llavamod_tpu")


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, and no JAX through a
    library that would load it by itself."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> List[str]:
    """Top-level names in sys.modules that are on the forbidden list."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    """The cell's own file, benchmark/workloads/<name>.json."""
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> Dict[str, Any]:
    """A configuration's file, benchmark/configs/<name>.json."""
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    """A traffic mix's parameters, benchmark/traffic/<name>.json."""
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def architecture(cfg: Dict[str, Any], side: str):
    """The module of the configuration's decoder architecture (its
    `architecture` key) on one side: "harness" loads
    benchmark/harness/arch/<name>.py (the parameter layout, the program's
    decoder arguments, the operation and byte counts), "reference"
    benchmark/reference/arch/<name>.py (the plain float32 decoder).  Both
    files have to be there; a name without them fails at once, naming
    them."""
    import importlib.util

    name = cfg.get("architecture")
    paths = {s: BENCH_DIR / s / "arch" / f"{name}.py"
             for s in ("harness", "reference")}
    if not name or not all(p.exists() for p in paths.values()):
        raise FileNotFoundError(
            f"configuration {cfg.get('name')!r} names the architecture "
            f"{name!r}; a configuration's architecture needs two files: "
            f"benchmark/harness/arch/{name}.py (its parameter layout, the "
            f"program's decoder arguments, its operation and byte counts) "
            f"and benchmark/reference/arch/{name}.py (its plain float32 "
            f"decoder)")
    path = paths[side]
    mod = _ARCHS.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"bench_arch_{side}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ARCHS[path] = mod
    return mod


_ARCHS: Dict[Path, Any] = {}


def cell_metrics(name: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics of `BENCHMARK.json` that this cell reports: its
    end-to-end metrics in an untraced run, its per-layer ones traced."""
    spec = benchmark_spec()
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or name in m["workloads"]:
            out.append(m)
    return out


def card_info() -> Dict[str, str]:
    """nvidia-smi's name, power limit, SM clock and temperature of card 0
    (empty where nvidia-smi is absent)."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(q.split(","), vals))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error, then the result as the last line of standard output,
    with the comparisons under a key of their own that comes last."""
    for c in checks:
        log(f"[check] {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'ok' if c['ok'] else 'FAILED'})")
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


def check(name: str, value: Optional[float], limit: float) -> Dict[str, Any]:
    """One comparison: passes when `value` is a number not above `limit`.
    A missing number fails."""
    ok = value is not None and value == value and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
