"""One rank of a distillation run on several ranks with its timed path
broken underneath (test_bench_dist.py), started as the cell's workers are:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        benchmark/tests/dist_fault_worker.py <run directory> <fault>

* `unchanged`: the step returns its state unchanged (no update);
* `half_batch`: the second half of each row's tokens left out of the
  loss, its mean taken over the rest;
* `no_exchange`: the gradients' exchange between the ranks left out
  (FSDP2 neither reduce-scatters nor all-reduces them);
* `loads_jax`: the run is sound, but the rank imports a stand-in module
  named `jax` (written under the run directory), which stays loaded.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402


def plant(fault: str) -> None:
    from llavamod_tpu_torch.parallel import sharding
    from llavamod_tpu_torch.train import steps

    if fault == "unchanged":
        def unchanged(state, metrics, cfg=None):
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = torch.zeros(())
            return state._replace(step=state.step + 1), metrics

        steps._apply_update = unchanged
    elif fault == "half_batch":
        orig = steps.kd_ce_align_loss

        def half(hidden_s, w_s, hidden_t, w_t, labels, **kw):
            labels = labels.clone()
            labels[:, labels.shape[1] // 2:] = -100
            return orig(hidden_s, w_s, hidden_t, w_t, labels, **kw)

        steps.kd_ce_align_loss = half
    elif fault == "no_exchange":
        orig = sharding.shard_params

        def unsynced(mesh, model, *a, **kw):
            out = orig(mesh, model, *a, **kw)
            if sharding.is_sharded(model):
                model.set_requires_gradient_sync(False, recurse=True)
            return out

        sharding.shard_params = unsynced
    elif fault == "loads_jax":
        stub = Path(sys.argv[1]) / f"stub{os.environ['RANK']}"
        stub.mkdir()
        (stub / "jax.py").write_text('"""A stand-in of the JAX package."""\n')
        sys.path.insert(0, str(stub))
        import jax  # noqa: F401
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    plant(sys.argv[2])
    from benchmark.drivers import distill_dist

    distill_dist.worker(sys.argv[1])
