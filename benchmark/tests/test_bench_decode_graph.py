"""decode_graphed_share.serve against hand-worked span lists: the share of
decode steps that replayed a CUDA graph, and None where the program's
spans carry no graph attribute (a program without graphed decode) or
there are none."""

import pytest

from benchmark import run
from benchmark.tests.test_bench_spans import SERVE, TRAIN, S


def _steps(*paths):
    return [S("generate.decode_step", 10 * i, 10 * i + 5, device_ms=4.0,
              **({"graph": p} if p else {}))
            for i, p in enumerate(paths)]


@pytest.mark.parametrize("spans,want", [
    (_steps("replay", "replay", "replay"), 100.0),
    (_steps("eager", "capture", "replay", "replay"), 50.0),
    (_steps("eager", "eager"), 0.0),
    (SERVE[:2] + _steps("replay", "eager"), 50.0),
    (SERVE, None),                 # decode steps without the attribute
    (TRAIN, None),
    ([], None),
])
def test_decode_graphed_share_by_hand(spans, want):
    got = run.read_metric("decode_graphed_share.serve", {"spans": spans})
    assert got == (None if want is None else pytest.approx(want))
