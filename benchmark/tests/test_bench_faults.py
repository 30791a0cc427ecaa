"""Each cell's comparison against broken runs, on the CPU at a tiny size:
the harness's look for a card is skipped and the rest of a run is driven
with the timed path broken underneath; `correct` has to come out false.
The controls (the reference in the precision below the configuration's)
have to fail the tiny cells' limits too, and so have the planted faults
of the training reference; at the cells' own sizes that is held on the
card (test_bench_card.py)."""

import time

import torch

from benchmark.tests import tiny

SEED = 2 ** 31 + 4242


def _run(driver, **kw):
    from benchmark.drivers import distill, serve

    torch.manual_seed(0)
    with tiny.tiny_files():
        mod, cell = ((distill, tiny.DISTILL) if driver == "distill"
                     else (serve, tiny.SERVE))
        return mod.run("t", cell, SEED, 1.0, False, "cpu", time.perf_counter(),
                       log=lambda *a: None, **kw)


def _correct(out) -> bool:
    return all(c["ok"] for c in out["checks"])


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from llavamod_tpu_torch.train import steps

    def unchanged(state, metrics, cfg=None):
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = torch.zeros(())
        return state._replace(step=state.step + 1), metrics

    monkeypatch.setattr(steps, "_apply_update", unchanged)
    assert not _correct(_run("distill"))


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from llavamod_tpu_torch.train import steps

    orig = steps.kd_ce_align_loss

    def half(hidden_s, w_s, hidden_t, w_t, labels, **kw):
        labels = labels.clone()
        labels[:, labels.shape[1] // 2:] = -100
        return orig(hidden_s, w_s, hidden_t, w_t, labels, **kw)

    monkeypatch.setattr(steps, "kd_ce_align_loss", half)
    assert not _correct(_run("distill"))


def test_half_of_the_accumulation_left_out_is_not_correct(monkeypatch):
    from llavamod_tpu_torch.train import optim

    orig = optim.MultiSteps.update

    def half(self, grads):
        k, h, n = self.k, self.k // 2, self.mini_step
        if n < h:       # the first half of the microbatches never count
            self.mini_step = n + 1
            return self.inner.norm(grads)
        self.k, self.mini_step = k - h, n - h
        try:            # the mean over the rest
            return orig(self, grads)
        finally:
            self.k = k
            if self.mini_step:
                self.mini_step += h

    monkeypatch.setattr(optim.MultiSteps, "update", half)
    assert not _correct(_run("distill"))


def test_an_update_with_its_sign_flipped_is_not_correct(monkeypatch):
    from llavamod_tpu_torch.train import optim

    orig = optim.AdamW.update

    def flipped(self, grads):
        before = {n: p.detach().clone() for n, p in self.params.items()}
        orig(self, grads)
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(2 * before[n] - p)

    monkeypatch.setattr(optim.AdamW, "update", flipped)
    assert not _correct(_run("distill"))


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from llavamod_tpu_torch import generation

    orig = generation._pick

    def altered(logits, gcfg, gen):
        return (orig(logits, gcfg, gen) + 1) % logits.shape[-1]

    monkeypatch.setattr(generation, "_pick", altered)
    assert not _correct(_run("serve"))


def test_the_training_control_and_faults_fail_the_tiny_limits():
    from benchmark import controls

    with tiny.tiny_files():
        got = controls.distill_controls("t", tiny.DISTILL, SEED, "cpu",
                                        log=lambda *a: None)
    lim = tiny.DISTILL["limits"]
    assert got["correct"], got
    for label, _ in controls.VARIANTS:
        assert any(got[label][k] > lim[k] for k in lim), (label, got)


def test_the_serving_control_fails_the_tiny_limit():
    from benchmark.drivers import serve

    out = _run("serve", control=True)
    assert _correct(out)
    assert any(out["reference"]["control_" + serve.NUMBERS[k]] > v
               for k, v in tiny.SERVE["limits"].items())
