"""Build and load the hand-written CUDA kernels of llavamod_tpu_torch/csrc.

The kernels are compiled with `nvcc` for `sm_90a`, one `nvcc -c` per
source, all started together, and linked into one shared library with a
plain C interface that is loaded through ctypes.  The build happens at first
use, from the package's own sources, into `build/llavamod_tpu_torch/` at the
repository root; the library name carries a hash of every file under
`csrc/` (the `.cu` sources and the `.cuh` headers they include) and of the
flags, so an edited source or header rebuilds and an unchanged tree is
reused.

Nothing here runs at import time: CPU-only installs import every module of
the package without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "llavamod_tpu_torch"
# the translation units (K1, K2, K3, K4); each includes `hopper.cuh`
SOURCES = ("flash_fwd.cu", "flash_decode.cu", "flash_dq.cu", "flash_dkv.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build (or reuse) did: library path, seconds, compiler log
build_info: Dict[str, object] = {}

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the llavamod_tpu_torch CUDA kernels cannot be built")


def digest(csrc: Path = CSRC_DIR) -> str:
    """Hash of the flags and of every `.cu` and `.cuh` file under `csrc`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.rglob("*.cu*")):
        if path.suffix in (".cu", ".cuh"):
            h.update(str(path.relative_to(csrc)).encode() + b"\0")
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; return their logs, raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{log}")
    return logs


def _compile(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                          str(CSRC_DIR / s)]
                         for s, o in zip(SOURCES, objs)])
        logs += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and return the loaded library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = BUILD_DIR / f"libllavamod_kernels_{digest()}.so"
        built = not out.exists()
        saved = out.with_suffix(".log")
        # a reused library keeps the compiler log of its build (registers,
        # spills) beside it
        log = (_compile(out) if built
               else saved.read_text() if saved.exists() else "")
        lib = ctypes.CDLL(str(out))
        lib.llavamod_flash_fwd.argtypes = [
            _p, _p, _p, _p, _p, _p, _p,          # q k v q_seg kv_seg o lse
            _i, _i, _i, _i, _i, _i,              # B H KH T S D
            ctypes.POINTER(ctypes.c_longlong),   # 12 element strides
            _f, _f, _i, _p]                      # scale softcap causal stream
        lib.llavamod_flash_fwd.restype = _i
        lib.llavamod_flash_decode.argtypes = [
            _p, _p, _p, _p, _p, _p, _p,          # q k v k_scale v_scale seg out
            _p, _p, _p,                          # split partials: acc m l
            _i, _i, _i, _i, _i, _i,              # B H KH S D splits
            _i, _i,                              # q_dtype cache_dtype
            _f, _f, _p]                          # scale softcap stream
        lib.llavamod_flash_decode.restype = _i
        bwd_head = [_p, _p, _p, _p, _p, _p, _p, _p]  # q k v dO lse delta segs
        dims = [_i, _i, _i, _i, _i, _i]              # B H KH T S D
        tail = [ctypes.POINTER(ctypes.c_longlong),   # 21 element strides
                _f, _f, _i, _p]                      # scale softcap causal stream
        lib.llavamod_flash_dq.argtypes = bwd_head + [_p] + dims + tail
        lib.llavamod_flash_dq.restype = _i
        lib.llavamod_flash_dkv.argtypes = bwd_head + [_p, _p] + dims + tail
        lib.llavamod_flash_dkv.restype = _i
        lib.llavamod_error_string.argtypes = [_i]
        lib.llavamod_error_string.restype = ctypes.c_char_p
        build_info.update(path=str(out), built=built,
                          seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().llavamod_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
