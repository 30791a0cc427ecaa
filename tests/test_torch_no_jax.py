"""The port imports torch and never jax: no file of llavamod_tpu_torch (nor
chip_smoke.py) imports jax, and importing every module of the port in a
fresh interpreter adds no jax module to sys.modules."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "llavamod_tpu_torch")
_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
                     r"from\s+jaxlib\b)", re.M)


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def _source(path):
    with open(path) as f:
        return f.read()


def test_no_port_file_imports_jax():
    offenders = [p for p in _port_files() if _IMPORT.search(_source(p))]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        "def jax_mods():\n"
        "    return {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')}\n"
        "before = jax_mods()\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(jax_mods() - before))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert len(_modules()) >= 20
