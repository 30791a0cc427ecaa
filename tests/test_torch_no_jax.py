"""The port imports torch, never jax, and nothing of the JAX package: no
file of llavamod_tpu_torch (nor chip_smoke.py) imports jax or llavamod_tpu
(the port keeps its own copies of the host modules it needs), and importing
every module of the port in a fresh interpreter adds no jax module to
sys.modules."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "llavamod_tpu_torch")
_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
                     r"from\s+jaxlib\b)", re.M)
_JAX_PACKAGE = re.compile(r"^\s*(from|import)\s+llavamod_tpu(\.|\s|$)", re.M)


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


def test_no_port_file_imports_the_jax_package():
    offenders = [p for p in _port_files() if _JAX_PACKAGE.search(_source(p))]
    assert not offenders, offenders
    # the pattern catches every import form and spares the port's own name
    for line in ("import llavamod_tpu", "from llavamod_tpu import x",
                 "    from llavamod_tpu.mm_utils import y",
                 "import llavamod_tpu.constants as c"):
        assert _JAX_PACKAGE.search(line), line
    assert not _JAX_PACKAGE.search("from llavamod_tpu_torch import x")


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
    # the trainer's modules and the W8A8 blocks are among those imported
    assert {f"llavamod_tpu_torch.{m}" for m in (
        "train.run", "train.args", "train.checkpoint", "train.sampler",
        "train.loader", "train.train", "train.align_train", "train.dpo_train",
        "data.preprocess", "data.dataset", "data.collator",
        "runtime.prefetch", "utils.logging", "utils.misc",
        "ops.int8")} <= set(_modules())
