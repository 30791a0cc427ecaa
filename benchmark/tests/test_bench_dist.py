"""The distillation cell on several cards (benchmark/drivers/distill_dist.py)
on the CPU at a tiny size, four ranks over gloo (two experts a rank, fsdp
2): a sound run is correct; its result is assembled from every rank's
readings; the one-card controls read the workers' row order and fail the
tiny limits; runs whose timed path is broken underneath in every worker
(benchmark/tests/dist_fault_worker.py) come out not correct; and a run
whose workers load a module named `jax` prints no result."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.drivers import distill_dist
from benchmark.harness import common, traffic
from benchmark.harness import weights as wmod
from benchmark.harness.tokenizer import StandInTokenizer
from benchmark.harness.trace import Summary
from benchmark.tests import tiny

SEED = 2 ** 31 + 515
FAULT_WORKER = Path(__file__).with_name("dist_fault_worker.py")


def _run(launch=None):
    with tiny.tiny_files():
        return distill_dist.run("t", tiny.DISTILL_DIST, SEED, 1.0, False,
                                "cpu", time.perf_counter(),
                                log=lambda *a: None, launch=launch)


def _correct(out) -> bool:
    return all(c["ok"] for c in out["checks"])


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_a_sound_four_rank_run_is_correct(sound):
    assert sound["checks"] and _correct(sound), sound["checks"]
    assert set(sound["readings"]) == set(tiny.DISTILL_DIST["limits"])


def test_the_result_holds_every_ranks_work(sound):
    world = tiny.DISTILL_DIST["chips"]
    assert sound["attempted"] > 0 and sound["attempted"] % world == 0
    e2e = sound["end_to_end"]
    assert e2e["train_tokens_per_s"] == sound["tokens"] / sound["ctx"]["window_s"]
    assert 0 < e2e["setup_s"] < 600
    # the first update's 2 steps and the one after, a row from every rank
    assert len(sound["order"]) == 3 * world
    assert len(set(sound["order"][:2 * world])) == 2 * world


def test_the_one_card_controls_read_the_workers_rows(sound, tmp_path):
    tok = StandInTokenizer()
    with tiny.tiny_files():
        cell = tiny.DISTILL_DIST
        cfg_s, mix = common.config(cell["config"]), common.traffic(cell["traffic"])
        data, folder, _, _ = traffic.write_conversations(
            mix, SEED, tok, wmod.n_image(cfg_s), str(tmp_path))
        order = distill_dist.first_update_order(cell, cfg_s, mix, SEED, data,
                                                folder, tok)
    assert order == sound["order"]


def test_the_controls_fail_the_tiny_limits():
    from benchmark import controls

    with tiny.tiny_files():
        got = distill_dist.controls(tiny.DISTILL_DIST, SEED, "cpu",
                                    controls.VARIANTS, log=lambda *a: None)
    lim = tiny.DISTILL_DIST["limits"]
    for label, _ in controls.VARIANTS:
        assert any(got[label][k] > lim[k] for k in lim), (label, got)


def _fake_rank(r, busy, forbidden=()):
    tr = Summary(2.0, busy, {"k": busy}, [("bench.step", 0.1)])
    return {"rank": r, "row_rank": 3 - r, "order": [(r, 0), (r, 1)],
            "tokens": 100 * (r + 1), "window_s": 4.0 if r == 0 else 9.0,
            "peak": 10 * r, "flops": {"bf16": 4.0}, "waits": [r], "trace": tr,
            "attn_least": 0.5, "spans": None, "microbatches": 5,
            "t_window_wall": 130.0, "forbidden": list(forbidden)}


def test_assembly_of_fake_ranks():
    out = distill_dist.assemble([_fake_rank(r, 1.0 + r) for r in range(4)],
                                100.0)
    assert out["end_to_end"] == {"train_tokens_per_s": 1000 / 4.0,
                                 "setup_s": 30.0}
    assert out["memory_peak_bytes"] == 30 and out["attempted"] == 20
    assert out["ctx"]["flops"] == {"bf16": 4.0}       # per card
    assert out["ctx"]["data_wait_s"] == [0] and out["ctx"]["trace"].busy_s == 1.0
    assert out["trace"].busy_s == 2.5 and out["trace"].window_s == 2.0
    assert out["order"] == [(3, 0), (2, 0), (1, 0), (0, 0),
                            (3, 1), (2, 1), (1, 1), (0, 1)]


def test_a_rank_that_holds_a_jax_module_refuses_the_assembly():
    ranks = [_fake_rank(r, 1.0, ["jax"] if r == 2 else []) for r in range(4)]
    with pytest.raises(RuntimeError, match=r"\{2: \['jax'\]\}"):
        distill_dist.assemble(ranks, 100.0)


def _launch(fault):
    def launch(root, world, log, timeout):
        subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nnodes", "1", "--nproc_per_node", str(world),
             str(FAULT_WORKER), root, fault],
            check=True, capture_output=True, cwd=str(common.ROOT),
            timeout=timeout)
    return launch


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange"])
def test_a_broken_four_rank_run_is_not_correct(fault):
    torch.manual_seed(0)
    assert not _correct(_run(_launch(fault)))


def test_a_worker_that_loads_jax_fails_the_run():
    torch.manual_seed(0)
    with pytest.raises(RuntimeError, match="JAX stack"):
        _run(_launch("loads_jax"))
