"""Nothing under benchmark/ loads the JAX stack or the JAX package, and
the reference loads nothing of the program: top-level module names,
compared whole, in a fresh interpreter."""

import json
import subprocess
import sys

from benchmark.harness import common

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "llavamod_tpu")


def _modules_after_import(modules):
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(common.ROOT)!r})\n"
        f"for m in {modules!r}:\n"
        "    if m.endswith('.py'):\n"
        "        spec = importlib.util.spec_from_file_location('m', m)\n"
        "        spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    else:\n"
        "        importlib.import_module(m)\n"
        "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(common.ROOT),
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _benchmark_modules():
    mods = []
    for p in sorted(common.BENCH_DIR.rglob("*.py")):
        rel = p.relative_to(common.ROOT)
        if "metrics" in rel.parts or "-" in p.stem or "." in p.stem:
            mods.append(str(p))
        else:
            mods.append(".".join(rel.with_suffix("").parts))
    return mods


def test_no_module_of_the_benchmark_loads_jax():
    loaded = _modules_after_import(_benchmark_modules())
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    refs = [m for m in _benchmark_modules() if m.startswith("benchmark.reference")]
    loaded = _modules_after_import(refs)
    assert "llavamod_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
    assert "torch" in loaded


def test_the_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(common.BENCH_DIR / "run.py"), "--workload",
         "serve.2b.short", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(common.ROOT),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
