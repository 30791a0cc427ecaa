"""The C++ batch image preprocessor (`image_prep.cpp`), loaded through ctypes.

The port's own copy of llavamod_tpu/native: the same source and the same g++
flags, so the two packages give the same bits.  The library is built at
first use, from the package's source, into `build/llavamod_tpu_torch/` at
the repository root; its name carries a hash of the source, the flags and
the CPU that `-march=native` resolves to, so an edited source, or a tree
copied to another host, rebuilds.

Nothing falls back quietly: a missing compiler, a failed build or a failed
`dlopen` raises with the compiler's output.  `LLAVAMOD_NO_NATIVE=1` (the
JAX package's switch) is the one way to ask for the PIL path.  `counts`
records the path each batch of `mm_utils.ImagePreprocessor` took.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("image_prep.cpp")
BUILD_DIR = SRC.parents[2] / "build" / "llavamod_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# batches preprocessed by each path (ImagePreprocessor.__call__)
counts = {"native": 0, "pil": 0}


def enabled() -> bool:
    """False when LLAVAMOD_NO_NATIVE=1 asks for the PIL path."""
    return os.environ.get("LLAVAMOD_NO_NATIVE") != "1"


def count(path: str) -> None:
    with _lock:
        counts[path] += 1


def reset_counts() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the C++ image "
                           "preprocessor (llavamod_tpu_torch/native) cannot "
                           "be built; LLAVAMOD_NO_NATIVE=1 selects the PIL "
                           "path")
    return cxx


def _march(cxx: str) -> str:
    """The CPU that `-march=native` resolves to on this host."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return next((ln.split()[-1] for ln in out.splitlines()
                 if ln.strip().startswith("-march=")), "")


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_march(cxx).encode() + b"\0")
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libimageprep_{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{SRC}:\n{proc.stderr}")
    os.replace(tmp, out)   # concurrent builders never see a partial library


def load_library() -> ctypes.CDLL:
    """Build the library if needed and return it loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _cxx()
        path = library_path(cxx)
        if not path.exists():
            _build(cxx, path)
        lib = ctypes.CDLL(str(path))   # OSError names the file and the cause
        lib.llm_preprocess_batch.restype = ctypes.c_int
        lib.llm_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),                # imgs
            ctypes.POINTER(ctypes.c_int),                   # hs
            ctypes.POINTER(ctypes.c_int),                   # ws
            ctypes.c_int, ctypes.c_int, ctypes.c_int,       # n, size, pad
            ctypes.c_char_p,                                # bg
            ctypes.POINTER(ctypes.c_float),                 # mean
            ctypes.POINTER(ctypes.c_float),                 # std
            ctypes.POINTER(ctypes.c_float),                 # out
            ctypes.c_int,                                   # threads
        ]
        _lib = lib
        return _lib


def preprocess_batch(images: List[np.ndarray], out_size: int, *,
                     pad_square: bool, background, mean, std,
                     num_threads: int = 0) -> np.ndarray:
    """images: uint8 HWC arrays (3 channels) -> [N, 3, S, S] float32."""
    lib = load_library()
    n = len(images)
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in imgs:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"expected uint8 HWC RGB arrays, got shape "
                             f"{im.shape}")
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in imgs])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in imgs])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in imgs])
    bg = bytes(int(b) for b in background)
    mean_arr = (ctypes.c_float * 3)(*[float(x) for x in mean])
    std_arr = (ctypes.c_float * 3)(*[float(x) for x in std])
    out = np.empty((n, 3, out_size, out_size), np.float32)
    threads = num_threads or min(n, os.cpu_count() or 1)
    rc = lib.llm_preprocess_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), hs, ws,
        n, out_size, int(pad_square), bg, mean_arr, std_arr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if rc != 0:
        raise ValueError(f"llm_preprocess_batch returned {rc} for {n} "
                         f"images of shapes {[im.shape for im in imgs]}")
    return out
