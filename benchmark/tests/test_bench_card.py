"""On the card, at the cells' own sizes: each cell's control (and, for
the training cell, each planted fault) fails the cell's limits while the
program's own run passes them, read by benchmark/controls.py on a fresh
seed.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import common


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["distill.2b.recipe", "serve.2b.short",
                                  "serve.7b.short"])
def test_the_control_fails_the_cells_limits(card, cell):
    out = subprocess.run(
        [sys.executable, str(common.BENCH_DIR / "controls.py"), "--workload",
         cell, "--seeds", "3333333337", "--seconds", "8"],
        capture_output=True, text=True, check=True, cwd=str(common.ROOT))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    limits = common.workload(cell)["limits"]
    assert got["correct"], got
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    for label in [k for k in got if isinstance(got[k], dict)
                  and k != "program"]:
        assert any(got[label][k] > v for k, v in limits.items()), (label, got)
