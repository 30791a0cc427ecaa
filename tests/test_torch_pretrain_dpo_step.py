"""The port's stage-1 and stage-3 steps and what they stand on, against the
JAX package's on the same weights and inputs:

  * `sequence_log_prob` (sum and mean, a vocab limit, chunks smaller than
    the vocab) and `dpo_loss` (sigmoid, hinge, ipo, kto_pair, each with and
    without reference_free): values and gradients, f32, within 1e-5;
  * `make_pretrain_step` (projector only, full SFT, MoE with the router aux
    loss, in-step row chunks, gradient accumulation) and `make_dpo_step`
    (kto_pair and sigmoid, the reference on the policy's tower features):
    every metric per step and every parameter after 3-4 steps within 1.5e-3;
  * MultiSteps with accumulation 2 over 4 microbatches against
    optax.MultiSteps, within 1e-6;
  * a tied-embedding model that also carries an explicit, trainable
    lm_head: the port's head takes its exact gradient.  (The JAX step would
    stream it as frozen and give it none: `_head_weight_frozen` reads the
    tie flag, ROADMAP Queue 3; the reference here is JAX's exact path.)"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from util_torch_port import (
    flatten_numpy,
    matched_llava,
    tiny_llava_config,
    to_jax_llava,
)

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.ops import losses as jlosses
from llavamod_tpu.train import optim as joptim
from llavamod_tpu.train import steps as jsteps
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.params import ParamGroup
from llavamod_tpu_torch.ops import losses as tlosses
from llavamod_tpu_torch.train import optim as toptim
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import (
    batch_from_arrays,
    make_dpo_step,
    make_pretrain_step,
)

TOL = 1.5e-3
LOSS_TOL = 1e-5
VOCAB, CHUNK, T = 1000, 96, 24


def _close(got, want, tol=LOSS_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("average,vocab_limit,chunk", [
    (False, None, 64), (True, None, 64), (False, 150, 32), (True, 150, 1000)],
    ids=["sum", "mean", "limit-sum", "limit-mean-one-chunk"])
def test_sequence_log_prob_values_and_gradients(average, vocab_limit, chunk):
    rng = np.random.RandomState(0)
    b, t, d, v = 3, 10, 16, 200
    h = rng.randn(b, t, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.3).astype(np.float32)
    labels = rng.randint(0, vocab_limit or v, (b, t)).astype(np.int32)
    labels[:, :3] = -100
    labels[2, 5:] = -100
    cot = rng.randn(b).astype(np.float32)
    kw = dict(vocab_limit=vocab_limit, average=average, chunk=chunk)

    def jf(h_, w_):
        return jnp.sum(jlosses.sequence_log_prob(h_, w_, jnp.asarray(labels),
                                                 **kw) * cot)

    jval = jlosses.sequence_log_prob(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels), **kw)
    jdh, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    val = tlosses.sequence_log_prob(th, tw, torch.tensor(labels), **kw)
    (val * torch.tensor(cot)).sum().backward()
    _close(val.detach(), jval)
    _close(th.grad, jdh)
    _close(tw.grad, jdw)
    # the frozen-head flag reorders nothing: same values, same dh, no dW
    th2 = torch.tensor(h, requires_grad=True)
    val2 = tlosses.sequence_log_prob(th2, torch.tensor(w),
                                     torch.tensor(labels), stream_dh=True, **kw)
    (val2 * torch.tensor(cot)).sum().backward()
    _close(val2.detach(), jval)
    _close(th2.grad, jdh)


@pytest.mark.parametrize("reference_free", [False, True],
                         ids=["ref", "ref-free"])
@pytest.mark.parametrize("loss_type", ["sigmoid", "hinge", "ipo", "kto_pair"])
def test_dpo_loss_values_and_gradients(loss_type, reference_free):
    rng = np.random.RandomState(1)
    pc, pr, rc, rr = (rng.randn(4).astype(np.float32) * 3 for _ in range(4))
    kw = dict(beta=0.1, label_smoothing=0.1 if loss_type == "sigmoid" else 0.0,
              loss_type=loss_type, reference_free=reference_free)
    cot = rng.randn(8 if loss_type == "kto_pair" else 4).astype(np.float32)

    def jf(a, b_):
        out = jlosses.dpo_loss(a, b_, jnp.asarray(rc), jnp.asarray(rr), **kw)
        return jnp.sum(out.losses * cot)

    jout = jlosses.dpo_loss(jnp.asarray(pc), jnp.asarray(pr), jnp.asarray(rc),
                            jnp.asarray(rr), **kw)
    jgc, jgr = jax.grad(jf, argnums=(0, 1))(jnp.asarray(pc), jnp.asarray(pr))
    tpc = torch.tensor(pc, requires_grad=True)
    tpr = torch.tensor(pr, requires_grad=True)
    out = tlosses.dpo_loss(tpc, tpr, torch.tensor(rc), torch.tensor(rr), **kw)
    (out.losses * torch.tensor(cot)).sum().backward()
    assert out.losses.shape == jout.losses.shape
    for name in ("losses", "chosen_rewards", "rejected_rewards"):
        _close(getattr(out, name).detach(), getattr(jout, name), msg=name)
    assert not out.chosen_rewards.requires_grad
    _close(tpc.grad, jgc)
    _close(tpr.grad, jgr)


# ---------------------------------------------------------------------------
# MultiSteps
# ---------------------------------------------------------------------------

def test_multisteps_accumulation_matches_optax():
    cfg = dict(stage="align", train_modules=("/gate", "/up", "/down", "router"),
               learning_rate=1e-2, mm_projector_lr=3e-3, weight_decay=0.1,
               warmup_ratio=0.0, total_steps=4, max_grad_norm=1.0,
               grad_accum_steps=2)
    _, jparams, model = matched_llava(tiny_llava_config())
    mask = {k: bool(v) for k, v in flatten_numpy(joptim.trainable_mask(
        jparams, JTrainConfig(**cfg))).items()}
    opt = joptim.build_optimizer(jparams, JTrainConfig(**cfg))
    jstate = opt.init(jparams)
    jupdate = jax.jit(opt.update)
    state = TrainState.create(model, TrainConfig(**cfg))
    assert isinstance(state.opt, toptim.MultiSteps)
    rng = np.random.RandomState(0)
    flat = flatten_numpy(jax.device_get(jparams))
    for i in range(4):
        scale = 0.5 if i == 2 else 0.01   # one mean clips, one does not
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             if mask[k] else np.zeros_like(v) for k, v in flat.items()}
        updates, jstate = jupdate(_unflatten(jparams, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = state.opt.update({k: torch.tensor(g[k]) for k in state.opt.params})
        _close(norm, float(optax.global_norm(
            {k: v for k, v in g.items() if mask[k]})), 1e-6)
        assert state.opt.mini_step == (i + 1) % 2
        assert state.opt.updates == (i + 1) // 2
        want = flatten_numpy(jax.device_get(jparams))
        got = numpy_from_state_dict(model)
        for k in want:
            _close(got[k], want[k], 1e-6, f"microbatch {i} {k}")


def _unflatten(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return jnp.asarray(flat[prefix])


# ---------------------------------------------------------------------------
# make_pretrain_step
# ---------------------------------------------------------------------------

def _arrays(cfg, b=2, seed=0, prefix=""):
    """b rows, row 1 left padded by 5; one image per row right after the
    first real token; labels masked on the image slots and the first T/4
    (row 2, when there, has no supervised token at all)."""
    rng = np.random.RandomState(seed)
    n_img, s = cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, VOCAB, (b, T)).astype(np.int32)
    seg = np.ones((b, T), np.int32)
    seg[1, :5] = 0
    ids[1, :5] = 0
    im = np.zeros((b, T), bool)
    ip = np.zeros((b, T), np.int32)
    for i in range(b):
        st = 1 + 5 * (i == 1)
        im[i, st:st + n_img] = True
        ip[i, st:st + n_img] = i * n_img + np.arange(n_img)
    labels = np.where(im | (seg == 0), -100, ids)
    labels[:, :T // 4] = -100
    if b > 2:
        labels[2] = -100
    out = {prefix + "input_ids": ids, prefix + "segment_ids": seg,
           prefix + "image_mask": im, prefix + "image_pos": ip,
           prefix + "labels": labels}
    out["pixels"] = rng.randn(b, 1, 3, s, s).astype(np.float32)
    out["pixel_valid"] = np.ones((b, 1), bool)
    return out


def _compare(jm, m, names, i):
    assert set(m) == set(jm), (sorted(m), sorted(jm))
    for name in names:
        _close(m[name].item(), float(jm[name]), TOL, f"step {i} {name}")


def _compare_params(jparams, model, init):
    want = flatten_numpy(jax.device_get(jparams))
    got = numpy_from_state_dict(model)
    assert got.keys() == want.keys()
    for key, w in want.items():
        _close(got[key], w, TOL, key)
    return {k for k in want if not np.array_equal(want[k], init[k])}


@pytest.mark.parametrize("case", [
    "projector_only", "full_sft", "moe_aux", "row_chunks", "moe_row_chunks",
    "accum"])
def test_pretrain_step_matches_jax(case):
    moe = case.startswith("moe")
    cfg = tiny_llava_config(vocab_size=VOCAB) if moe else tiny_llava_config(
        vocab_size=VOCAB, moe_num_experts=0, moe_layers=())
    kw = dict(stage="finetune", compute_dtype="float32", vocab_chunk=CHUNK,
              learning_rate=5e-4, weight_decay=0.1, warmup_ratio=0.2,
              total_steps=10, max_grad_norm=1.0, remat=case == "full_sft")
    if case == "projector_only":
        kw.update(stage="pretrain", tune_mm_mlp_adapter=True)
    if case.endswith("row_chunks"):
        kw.update(grad_row_chunks=3)
    if case == "accum":
        kw.update(grad_accum_steps=2, total_steps=2)
    b = 3 if case.endswith("row_chunks") else 2
    _, jparams, model = matched_llava(cfg, seed=0)
    init = flatten_numpy(jax.device_get(jparams))
    arrays = _arrays(cfg, b=b)
    jstep = jsteps.make_pretrain_step(to_jax_llava(cfg), JTrainConfig(**kw))
    jstate = joptim.TrainState.create(jparams, JTrainConfig(**kw))
    jb = jsteps.batch_from_arrays(arrays)
    step = make_pretrain_step(cfg, TrainConfig(**kw))
    state = TrainState.create(model, TrainConfig(**kw))
    tb = batch_from_arrays(arrays, device="cpu")
    names = ["loss", "loss/lm", "num_tokens", "grad_norm"] + (
        ["loss/moe_balance"] if moe else [])
    n_steps = 4 if case == "accum" else 3
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        _compare(jm, m, names, i)
    assert state.step == n_steps
    moved = _compare_params(jstate.params, state.model, init)
    if case == "projector_only":
        assert moved == {k for k in init if k.startswith("projector")}
    else:
        assert "llm.layers.1.attn.wq" in moved
        assert not any(k.startswith("vision") for k in moved)


def test_row_chunks_sum_to_the_one_shot_gradient():
    """grad_row_chunks=3 (one chunk without a supervised token) against
    one-shot: the same loss and the same gradient, so the same update."""
    cfg = tiny_llava_config(vocab_size=VOCAB, moe_num_experts=0, moe_layers=())
    kw = dict(stage="finetune", compute_dtype="float32", vocab_chunk=CHUNK,
              learning_rate=1e-3, warmup_ratio=0.0, max_grad_norm=0.0)
    tb = batch_from_arrays(_arrays(cfg, b=3), device="cpu")
    out = []
    for n_ck in (1, 3):
        model = matched_llava(cfg, seed=0)[2]
        tcfg = TrainConfig(grad_row_chunks=n_ck, **kw)
        state, m = make_pretrain_step(cfg, tcfg)(TrainState.create(model, tcfg),
                                                 tb)
        out.append((m, numpy_from_state_dict(state.model)))
    (m1, p1), (m3, p3) = out
    for name in ("loss", "loss/lm", "num_tokens", "grad_norm"):
        _close(m3[name].item(), m1[name].item(), 1e-5, name)
    for k in p1:
        _close(p3[k], p1[k], 1e-5, k)


def test_tied_model_with_an_explicit_trainable_head_trains_the_head():
    cfg = tiny_llava_config(vocab_size=VOCAB, moe_num_experts=0,
                            moe_layers=(), tie_word_embeddings=True)
    kw = dict(stage="finetune", compute_dtype="float32", vocab_chunk=CHUNK,
              learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
              train_modules=("lm_head",), max_grad_norm=1.0)
    jcfg, jparams, model = matched_llava(cfg, seed=0)
    head = np.random.RandomState(9).randn(VOCAB, cfg.llm.hidden_size).astype(
        np.float32) * 0.05
    jparams["llm"]["lm_head"] = {"weight": jnp.asarray(head)}
    model.llm.lm_head = ParamGroup(weight=torch.tensor(head))
    arrays = _arrays(cfg)
    jtcfg = JTrainConfig(**kw)
    jb = jsteps.batch_from_arrays(arrays)

    def exact_loss(params):     # JAX's step with the exact head backward
        params = jsteps._stop_frozen(params, jtcfg)
        out, w = jsteps._student_forward(params, jcfg, jb, jtcfg)
        return jlosses.softmax_cross_entropy(out.hidden, w, jb.labels,
                                             chunk=CHUNK,
                                             stream_dh=False).loss

    grads = jax.jit(jax.grad(exact_loss))(jparams)
    assert float(jnp.abs(grads["llm"]["lm_head"]["weight"]).max()) > 0
    opt = joptim.build_optimizer(jparams, jtcfg)
    updates, _ = jax.jit(opt.update)(grads, opt.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)

    tcfg = TrainConfig(**kw)
    state = TrainState.create(model, tcfg)
    assert "llm.lm_head.weight" in state.opt.params
    assert "llm.embed.embedding" not in state.opt.params
    state, m = make_pretrain_step(cfg, tcfg)(
        state, batch_from_arrays(arrays, device="cpu"))
    _close(m["grad_norm"].item(), float(optax.global_norm(grads)), TOL)
    got = numpy_from_state_dict(state.model)
    _close(got["llm.lm_head.weight"], np.asarray(want["llm"]["lm_head"]["weight"]),
           TOL, "lm_head")
    assert not np.array_equal(got["llm.lm_head.weight"], head)


# ---------------------------------------------------------------------------
# make_dpo_step
# ---------------------------------------------------------------------------

def _pair_arrays(cfg, seed=0):
    chosen = _arrays(cfg, seed=seed, prefix="chosen_")
    rejected = _arrays(cfg, seed=seed + 1, prefix="rejected_")
    for k in ("image_mask", "image_pos", "segment_ids"):
        rejected["rejected_" + k] = chosen["chosen_" + k]
    rejected.pop("pixels"), rejected.pop("pixel_valid")
    return {**chosen, **rejected}


@pytest.mark.parametrize("loss_type", ["kto_pair", "sigmoid"])
def test_dpo_step_matches_jax(loss_type):
    policy = tiny_llava_config(vocab_size=VOCAB)
    ref = policy.replace(llm=policy.llm.replace(
        name="tiny-ref", hidden_size=96, intermediate_size=160, num_heads=4,
        num_kv_heads=4, moe_num_experts=0, moe_layers=()))
    _, jparams, model = matched_llava(policy, seed=0)
    jref = jllava.init(to_jax_llava(ref), jax.random.PRNGKey(7))
    jref = {k: v for k, v in jref.items() if k != "vision"}
    tref = tllava.init(ref, torch.Generator().manual_seed(7), vision=False)
    load_jax_params(tref, jax.device_get(jref))
    kw = dict(stage="dpo", dpo_loss_type=loss_type, dpo_beta=0.5,
              moe_loss_enable=True, compute_dtype="float32",
              vocab_chunk=CHUNK, learning_rate=5e-4, warmup_ratio=0.0,
              total_steps=10, max_grad_norm=1.0, remat=loss_type == "kto_pair")
    arrays = _pair_arrays(policy)
    init = flatten_numpy(jax.device_get(jparams))
    jstep = jsteps.make_dpo_step(to_jax_llava(policy), to_jax_llava(ref),
                                 JTrainConfig(**kw))
    jstate = joptim.TrainState.create(jparams, JTrainConfig(**kw))
    step = make_dpo_step(policy, ref, TrainConfig(**kw))
    state = TrainState.create(model, TrainConfig(**kw))
    tarrays = {k: torch.as_tensor(v) for k, v in arrays.items()}
    names = ["loss", "loss/dpo", "rewards/chosen", "rewards/rejected",
             "rewards/accuracies", "rewards/margins", "logps/chosen",
             "logps/rejected", "loss/moe_balance", "grad_norm"]
    for i in range(3):
        jstate, jm = jstep(jstate, jref, arrays)
        state, m = step(state, tref, tarrays)
        _compare(jm, m, names, i)
    moved = _compare_params(jstate.params, state.model, init)
    assert "llm.layers.0.mlp.router" in moved and "llm.embed.embedding" in moved
    assert not any(k.startswith("vision") for k in moved)
