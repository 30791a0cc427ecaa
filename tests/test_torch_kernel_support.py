"""CPU tests of what surrounds the hand-written kernels: the tolerance that
holds each kernel to its plain version (shared by chip_smoke.py and the
gpu-marked kernel tests) and the build digest that decides when the
kernels' library is rebuilt."""

import math
import shutil

import pytest
import torch

from llavamod_tpu_torch.ops import cuda_build
from llavamod_tpu_torch.ops.tolerance import (
    KERNEL_ATOL,
    KERNEL_RTOL,
    max_abs_err,
    tol_ratio,
    within_tol,
)


@pytest.mark.parametrize("want,err,ok", [
    (0.0, 0.0199, True),            # the absolute term near zero
    (0.0, 0.0201, False),
    (3.0, 0.0156, True),            # one bf16 ulp of an entry in [2, 4)
    (3.0, KERNEL_ATOL + KERNEL_RTOL * 3.0 - 1e-4, True),
    (3.0, KERNEL_ATOL + KERNEL_RTOL * 3.0 + 1e-4, False),
    (-100.0, 0.5, True),            # the relative term uses |want|
    (-100.0, 1.2, False),
])
def test_elementwise_tolerance(want, err, ok):
    w = torch.tensor([want, 1.0, -1.0])
    g = w.clone()
    g[0] += err
    assert within_tol(g, w) is ok
    assert math.isclose(max_abs_err(g, w), err, rel_tol=1e-3, abs_tol=1e-6)
    assert math.isclose(tol_ratio(g, w),
                        err / (KERNEL_ATOL + KERNEL_RTOL * abs(want)),
                        rel_tol=1e-3, abs_tol=1e-6)


def test_tolerance_edge_cases():
    e = torch.zeros(0)
    assert tol_ratio(e, e) == 0.0 and max_abs_err(e, e) == 0.0
    w = torch.ones(4)
    assert not within_tol(torch.tensor([1.0, float("nan"), 1.0, 1.0]), w)
    assert not within_tol(torch.tensor([1.0, float("inf"), 1.0, 1.0]), w)
    with pytest.raises(ValueError):
        tol_ratio(torch.ones(3), torch.ones(4))
    # bf16 inputs are compared in f32
    x = torch.randn(64, generator=torch.Generator().manual_seed(0))
    assert within_tol(x.bfloat16(), x)


def test_digest_covers_headers_sources_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    base = cuda_build.digest(csrc)
    assert base == cuda_build.digest(csrc)          # stable
    assert base == cuda_build.digest(cuda_build.CSRC_DIR)

    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = cuda_build.digest(csrc)
    assert edited != base

    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n")
    assert cuda_build.digest(csrc) not in (base, edited)

    (csrc / "extra.cuh").write_text("#pragma once\n")   # a new header
    with_new = cuda_build.digest(csrc)
    assert with_new != cuda_build.digest(cuda_build.CSRC_DIR)

    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        (*cuda_build.NVCC_FLAGS, "-lineinfo"))
    assert cuda_build.digest(csrc) != with_new


def test_every_source_is_built():
    on_disk = sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cu"))
    assert sorted(cuda_build.SOURCES) == on_disk
