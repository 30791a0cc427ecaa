"""Tensor and sequence parallelism of the port (llavamod_tpu_torch/parallel/,
the decoder's column / row splits, the vocab-parallel losses, train/run.py
with --tensor_parallel) on the CPU under gloo: 2 and 4 ranks spawned with
torch.multiprocessing, rendezvous through a FileStore.  The ranks of a
tensor group hold the same rows, so a world of 2 at tensor=2 trains one row
a microbatch and a world of 4 at (fsdp=2 or expert=2, tensor=2) two; the
single-process references run those rows.  The model and data are
tests/test_torch_distributed.py's (a tiny LLaVA-MoD: 2 layers, width 64, 4
heads over 2 KV heads, F 128, 4 experts top-2 on both layers, vocab 512,
capacity factor 1.0; a dense teacher of 4 heads, F 160), weights carried
from the JAX package's init by interop/from_jax.py.

  * per op at tensor=2 against the unsplit op in the same process: the
    column / row `dense` pair, the vocab-parallel embedding, attention on
    the local heads (plain path), the MoE block in gather, ragged and
    einsum dispatch, the row-parallel W8A8 product (bitwise), the
    vocab-parallel chunked KD + CE and `sequence_log_prob` (forward and
    gradients, with a vocabulary that leaves each rank a partial last
    chunk, float and int8 heads), and the split of the fused `wqkv` /
    `gate_up` (rel 1e-5 in f32 where not bitwise);
  * whole steps: stage 2b (`run_stage("align")`, kd_lm, AdamW, accumulation
    2) at (tensor=2), (tensor=2, SP), (fsdp=2, tensor=2) and (expert=2,
    tensor=2), stage 1 (projector only) at (tensor=2, SP), (tensor=2) and
    (fsdp=2, tensor=2), stage 3 (kto_pair) at (tensor=2, SP), (tensor=2)
    and (expert=2, tensor=2), and Adafactor at (tensor=2, SP), every
    microbatch's loss and grad_norm within rel 2e-4 of the single-process
    port on the same rows and, for the align runs, of the JAX package's
    single-device `make_align_step`, and rank 0's `model.pt` the
    single-process run's weights; the SP runs recompute each layer
    (remat), so the collectives run again in the backward;
  * the replicated parameters are equal over the tensor ranks after the
    updates (AdamW and Adafactor); the sharded checkpoint at tensor=2
    resumes update 2 to the same metrics and weights;
  * attention with a KV cache under a tensor split (item 16: a prefill and
    a decode token on the rank's KV heads) against the unsplit op;
  * refusals: heads, KV heads, F or vocab that `tensor` does not divide,
    T % tensor under SP; --fused_update, --lora_enable (item 15) and
    --pipeline_parallel (item 14) under torch.distributed pass, the fused
    step under the pipeline is a ValueError."""

import copy
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_distributed import (
    ACCUM,
    METRICS,
    STEPS,
    TOL,
    _close,
    _jax_metrics,
    _lines,
    _models,
    _run,
    _state,
    _weights_close,
    _write_data,
)

from llavamod_tpu_torch.models import builder

OP_TOL = 1e-5
# the streamed int8 head folds bf16-rounded probabilities exp(s - m) into
# p@W, m the running max of the rank's own chunks: other roundings than
# the single process's (bf16 carries 2^-8 relative)
STREAM_TOL = 1e-3
MESHES = {
    "tp": dict(tensor_parallel=2),
    "tp_sp": dict(tensor_parallel=2, sequence_parallel=True, remat=True),
    "fsdp2_tp": dict(tensor_parallel=2),                      # world 4
    "expert2_tp": dict(tensor_parallel=2, expert_parallel=2),  # world 4
}


# ---------------------------------------------------------------------------
# per-op checks, run on every rank of a world of 2 at tensor=2
# ---------------------------------------------------------------------------

def _ctx(world):
    from llavamod_tpu_torch.parallel.collectives import ParallelContext
    from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return ParallelContext(make_mesh(MeshConfig(tensor=world), "cpu"))


def _sliced(module, cfg, pctx):
    """A copy of the decoder `module` holding the rank's tensor slices."""
    from llavamod_tpu_torch.parallel.sharding import (
        _keep_tensor_slices,
        tensor_split,
    )

    local = copy.deepcopy(module)
    _keep_tensor_slices(local, tensor_split(local, cfg, prefix=""),
                        pctx.tensor_rank, pctx.tensor_size)
    return local


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _op_checks(rank, root):
    """{check: relative error or bitwise flag} of the rank's split ops
    against the whole ops."""
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.models.llm.config import tiny_config
    from llavamod_tpu_torch.ops import losses
    from llavamod_tpu_torch.parallel.collectives import active
    from llavamod_tpu_torch.parallel.sharding import (
        join_slices,
        take_slice,
        tensor_split,
    )

    pctx = _ctx(2)
    out = {}
    g = torch.Generator().manual_seed(11)
    cfg = tiny_config(moe_num_experts=4, moe_layers=(1,),
                      moe_capacity_factor=1.0, num_layers=2)
    model = decoder.init(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for layer in model.layers:
            if layer.is_moe:
                layer.mlp.router.normal_(generator=g)
    x = torch.randn(2, 16, cfg.hidden_size, generator=g)
    pos = torch.arange(16)[None].expand(2, 16)
    seg = torch.ones(2, 16, dtype=torch.int32)
    seg[1, :3] = 0

    pattern = torch.linspace(-1, 1, x.numel()).reshape(x.shape)

    def grads(fn, mod, inp, seq=False):
        """(fn(mod, inp), d/d inp of a fixed linear functional of it; with
        `seq` the rank's T-shard of the whole functional)."""
        inp = inp.clone().requires_grad_(True)
        y = fn(mod, inp)
        pat = pattern.chunk(2, 1)[rank] if seq else pattern
        (y * pat).sum().backward()
        return y, inp.grad

    # the column / row dense pair (the dense MLP) and attention
    for name, fn in (
            ("mlp", lambda m, h: decoder.mlp_forward(cfg, m.layers[0].mlp, h)),
            ("attention", lambda m, h: decoder.attention_forward(
                cfg, m.layers[0].attn, h, pos, seg, 0, None, "xla"))):
        for seq in (False, True):
            c = cfg.replace(seq_shard_activations=seq)
            fn_c = ((lambda m, h: decoder.mlp_forward(c, m.layers[0].mlp, h))
                    if name == "mlp" else
                    (lambda m, h: decoder.attention_forward(
                        c, m.layers[0].attn, h, pos, seg, 0, None, "xla")))
            want, dwant = grads(fn, model, x)
            local = _sliced(model, cfg, pctx)
            xin = x.chunk(2, 1)[rank] if seq else x
            with active(pctx):
                got, dgot = grads(fn_c, local, xin, seq)
            ref = want.chunk(2, 1)[rank] if seq else want
            dref = dwant.chunk(2, 1)[rank] if seq else dwant
            tag = f"{name}{'_sp' if seq else ''}"
            out[tag] = max(_rel(got, ref), _rel(dgot, dref))
    # the vocab-parallel embedding
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    local = _sliced(model, cfg, pctx)
    with active(pctx):
        got = decoder.embed(local, cfg, ids)
    out["embed"] = _rel(got, decoder.embed(model, cfg, ids))
    # the MoE block, each dispatch, against the block under a context of
    # one row rank without a tensor split (the gather of the world's rows)
    moe = model.layers[1].mlp
    for dispatch in ("gather", "ragged", "einsum"):
        c = cfg.replace(moe_dispatch=dispatch)
        want, dwant = grads(lambda m, h: decoder.moe_block_forward(
            c, m, h, True, seg != 0)[0], moe, x)
        local = _sliced(model, cfg, pctx).layers[1].mlp
        with active(pctx):
            got, dgot = grads(lambda m, h: decoder.moe_block_forward(
                c, m, h, True, seg != 0)[0], local, x)
        out[f"moe_{dispatch}"] = max(_rel(got, want), _rel(dgot, dwant))
    # the row-parallel W8A8 product, bitwise, all-reduced and T-scattered
    w = decoder.quantize_dense_int8(torch.randn(96, 64, generator=g))
    h = torch.randn(2, 16, 96, generator=g)
    want = decoder.dense(h, w)
    w_loc = type(w)(take_slice(w.w_int8, _row_split(), rank, 2), w.scale)
    with active(pctx):
        got = decoder.row_dense(h.chunk(2, -1)[rank], w_loc, pctx, False)
        got_sp = decoder.row_dense(h.chunk(2, -1)[rank], w_loc, pctx, True)
    out["int8_row_bitwise"] = bool(torch.equal(got, want))
    out["int8_row_sp_bitwise"] = bool(torch.equal(got_sp,
                                                  want.chunk(2, 1)[rank]))
    # the fused wqkv / gate_up split, and back
    q8 = copy.deepcopy(model)
    decoder.quantize_decoder_int8(q8, include_lm_head=True)
    splits = tensor_split(q8, cfg, prefix="")
    fused = [k for k in splits if splits[k].parts is not None]
    ok = bool(fused)
    for k in fused:
        t = q8.state_dict()[k]
        parts = [take_slice(t, splits[k], r, 2) for r in range(2)]
        ok &= torch.equal(join_slices(parts, splits[k]), t)
    out["fused_roundtrip"] = ok
    hq = torch.randn(2, 16, cfg.hidden_size, generator=g)
    want = decoder.attention_forward(cfg, q8.layers[0].attn, hq, pos, seg, 0,
                                     None, "xla")
    want_mlp = decoder.mlp_forward(cfg, q8.layers[0].mlp, hq)
    local = _sliced(q8, cfg, pctx)
    whole, part = q8.state_dict(), local.state_dict()
    out["storage_kept"] = all(
        whole[k].is_contiguous() == part[k].is_contiguous()
        and part[k].shape[splits[k].dim] * 2 == whole[k].shape[splits[k].dim]
        for k in splits)
    with active(pctx):
        got = decoder.attention_forward(cfg, local.layers[0].attn, hq, pos,
                                        seg, 0, None, "xla")
        got_mlp = decoder.mlp_forward(cfg, local.layers[0].mlp, hq)
    out["fused_wqkv_bitwise"] = bool(torch.equal(got, want))
    out["fused_gate_up_bitwise"] = bool(torch.equal(got_mlp, want_mlp))
    # attention with a KV cache: a prefill, then one decode token
    _cache_checks(rank, pctx, out, cfg, model, g)
    # the vocab-parallel chunked losses: V = 512 over 2 ranks in chunks of
    # 96 (each rank's last chunk partial), vocab_limit 500 (rank 1 cut)
    _loss_checks(rank, pctx, out, g)
    if rank == 0:
        with open(os.path.join(root, "op_checks.json"), "w") as f:
            json.dump(out, f)


def _cache_checks(rank, pctx, out, cfg, model, g):
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.parallel.collectives import active

    x = torch.randn(2, 13, cfg.hidden_size, generator=g)
    pos = torch.arange(13)[None].expand(2, 13)
    seg = torch.ones(2, 13, dtype=torch.int32)
    local = _sliced(model, cfg, pctx)

    def run(mod, ctx):
        with torch.no_grad(), active(ctx):
            cache = decoder.init_cache(cfg, 2, 16, dtype=torch.float32)
            cache.segment[:, :12] = seg[:, :12]
            a = decoder.attention_forward(cfg, mod.layers[0].attn, x[:, :12],
                                          pos[:, :12], seg[:, :12], 0, cache,
                                          "fresh")
            cache = cache._replace(length=12)
            cache.segment[:, 12:13] = 1
            b = decoder.attention_forward(cfg, mod.layers[0].attn,
                                          x[:, 12:13], pos[:, 12:13],
                                          seg[:, 12:13], 0, cache)
        return torch.cat([a, b], dim=1), cache

    want, whole = run(model, None)
    got, part = run(local, pctx)
    kh = cfg.num_kv_heads // 2
    out["attention_cache"] = _rel(got, want)
    out["cache_heads"] = bool(
        part.k.shape[2] == kh and _rel(
            part.k[:, :, :, :13], whole.k[:, :, rank * kh:(rank + 1) * kh,
                                          :13]) <= OP_TOL)


def _row_split():
    from llavamod_tpu_torch.parallel.sharding import TensorSplit

    return TensorSplit(0)


def _loss_checks(rank, pctx, out, g):
    from llavamod_tpu_torch.models.llm.decoder import quantize_head_int8
    from llavamod_tpu_torch.ops import losses
    from llavamod_tpu_torch.parallel.collectives import active, copy_in

    n, d, v = 24, 32, 512
    h_s = torch.randn(2, n // 2, d, generator=g)
    h_t = torch.randn(2, n // 2, d, generator=g)
    w_s = torch.randn(v, d, generator=g) * 0.3
    w_t = torch.randn(v, d, generator=g) * 0.3
    labels = torch.randint(0, 500, (2, n // 2), generator=g)
    labels[0, :4] = -100
    kw = dict(vocab_limit=500, chunk=96)

    def run(hs, ws, local):
        hs = hs.clone().requires_grad_(True)
        ws = ws.clone().requires_grad_(True)
        wl = ws.chunk(2)[rank] if local else ws
        hin = copy_in(hs, pctx) if local else hs
        kd = losses.kd_ce_align_loss(hin, wl, h_t, w_t.chunk(2)[rank]
                                     if local else w_t, labels, **kw)
        lp = losses.sequence_log_prob(hin, wl, labels, **kw)
        ce = losses.softmax_cross_entropy(hin, wl, labels, **kw)
        total = kd.kd_loss + kd.ce_loss + (lp * torch.tensor(
            [0.3, -0.7])).sum() + ce.loss
        total.backward()
        dw = ws.grad.chunk(2)[rank] if local else ws.grad
        return (torch.stack([kd.kd_loss, kd.ce_loss, ce.loss]), lp,
                hs.grad, dw)

    want = run(h_s, w_s, False)
    with active(pctx):
        got = run(h_s, w_s, True)
    want = want[:3] + (want[3].chunk(2)[rank],)
    out["losses"] = max(_rel(a, b) for a, b in zip(got, want))
    # int8 heads (frozen): forward and dL/dh, streamed and two-pass
    for stream in (False, True):
        q_s, q_t = quantize_head_int8(w_s), quantize_head_int8(w_t)

        def run8(local):
            hs = h_s.clone().requires_grad_(True)
            hin = copy_in(hs, pctx) if local else hs

            def part(q):
                if not local:
                    return q
                return type(q)(q.w_int8.chunk(2)[rank], q.scale.chunk(2)[rank])
            kd = losses.kd_ce_align_loss(hin, part(q_s), h_t, part(q_t),
                                         labels, stream_dh=stream, **kw)
            lp = losses.sequence_log_prob(hin, part(q_s), labels,
                                          stream_dh=stream, **kw)
            total = kd.kd_loss + kd.ce_loss + lp.sum()
            total.backward()
            return torch.stack([kd.kd_loss, kd.ce_loss]), lp, hs.grad

        want = run8(False)
        with active(pctx):
            got = run8(True)
        out[f"losses_int8{'_stream' if stream else ''}"] = max(
            _rel(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def _replicated_equal(root, name, rank, model_state):
    """Every rank writes its replicated LLM parameters after the run."""
    torch.save(model_state, os.path.join(root, f"{name}_rank{rank}.pt"))


def _world(rank, world, store, root, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from llavamod_tpu_torch.train import run as trun

    try:
        for name, stage, targs in cases:
            if name == "ops":
                _op_checks(rank, root)
            elif name.startswith("resume"):
                at = ACCUM
                whole, cut = (os.path.join(root, f"{name}_{part}")
                              for part in ("whole", "cut"))
                _run(root, os.path.basename(whole), stage, 1, save_steps=at,
                     **targs)
                if rank == 0:
                    shutil.copytree(os.path.join(whole, f"checkpoint-{at}"),
                                    os.path.join(cut, f"checkpoint-{at}"))
                dist.barrier()
                _run(root, os.path.basename(cut), stage, 1, save_steps=at,
                     **targs)
            else:
                _run_keeping_replicas(trun, root, name, stage, rank, targs)
    finally:
        dist.destroy_process_group()


def _run_keeping_replicas(trun, root, name, stage, rank, targs):
    """`_run`, and each rank's replicated LLM parameters at the end."""
    from llavamod_tpu_torch.parallel.sharding import local_tensor

    kept = {}
    orig = trun.final_save

    def final_save(output_dir, cfg, state, *a, **k):
        splits = getattr(state.model, "tensor_split", {})
        for n, p in state.model.named_parameters():
            if n.startswith("llm.") and n not in splits:
                kept[n] = local_tensor(p).detach().clone()
        return orig(output_dir, cfg, state, *a, **k)

    trun.final_save = final_save
    try:
        _run(root, name, stage, 1, **targs)
    finally:
        trun.final_save = orig
    torch.save(kept, os.path.join(root, f"{name}_replicas{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tensor-parallel worlds (spawned first, running while this
    process does the single-process and JAX references)."""
    root = str(tmp_path_factory.mktemp("tp"))
    _write_data(root)
    student, jparams, teacher, jteacher = _models(root)
    sp = MESHES["tp_sp"]
    cases2 = [("ops", None, {}),
              ("tp", "align", MESHES["tp"]),
              ("tp_sp", "align", sp),
              ("tp_pretrain", "pretrain", sp),
              ("tp_dpo", "dpo", sp),
              ("tp_pretrain_nosp", "pretrain", MESHES["tp"]),
              ("tp_dpo_nosp", "dpo", MESHES["tp"]),
              ("tp_adafactor", "align", dict(sp, optimizer="adafactor")),
              ("resume_tp", "align", sp)]
    cases4 = [(name, "align", MESHES[name])
              for name in ("fsdp2_tp", "expert2_tp")]
    cases4 += [("fsdp2_tp_pretrain", "pretrain", MESHES["fsdp2_tp"]),
               ("expert2_tp_dpo", "dpo", MESHES["expert2_tp"])]
    procs = [mp.spawn(_world, args=(w, tempfile.mktemp(dir=root), root, c),
                      nprocs=w, join=False)
             for w, c in ((2, cases2), (4, cases4))]
    torch.set_num_threads(1)
    for name, stage, bsz, targs in (
            ("single_align1", "align", 1, {}),
            ("single_align2", "align", 2, {}),
            ("single_pretrain1", "pretrain", 1, {}),
            ("single_dpo1", "dpo", 1, {}),
            ("single_pretrain2", "pretrain", 2, {}),
            ("single_dpo2", "dpo", 2, {}),
            ("single_adafactor1", "align", 1, dict(optimizer="adafactor"))):
        _run(root, name, stage, bsz, **targs)
    jax_metrics = {b: _jax_metrics(root, student, jparams, teacher, jteacher,
                                   b) for b in (1, 2)}
    for p in procs:
        while not p.join():
            pass
    return root, jax_metrics


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", [
    "mlp", "mlp_sp", "attention", "attention_sp", "embed", "moe_gather",
    "moe_ragged", "moe_einsum", "losses", "losses_int8",
    "losses_int8_stream"])
def test_tensor_parallel_op_matches_the_unsplit_op(runs, check):
    root, _ = runs
    with open(os.path.join(root, "op_checks.json")) as f:
        got = json.load(f)
    tol = STREAM_TOL if check.endswith("_stream") else OP_TOL
    assert got[check] <= tol, (check, got[check])


@pytest.mark.parametrize("check", [
    "int8_row_bitwise", "int8_row_sp_bitwise", "fused_roundtrip",
    "fused_wqkv_bitwise", "fused_gate_up_bitwise", "storage_kept"])
def test_tensor_parallel_int8_products_are_bitwise(runs, check):
    """The row-parallel W8A8 product (the whole row's scale, int32 partial
    sums reduced before the rescale) and the fused wqkv / gate_up split
    block by block give the single-process bits; a slice keeps its
    tensor's storage order (an int8 weight stays K-major, the head
    row-major) and half its split dim."""
    root, _ = runs
    with open(os.path.join(root, "op_checks.json")) as f:
        assert json.load(f)[check] is True


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tensor_parallel_align_matches_single_process_and_jax(runs, mesh):
    root, jax_metrics = runs
    bsz = 2 if mesh in ("fsdp2_tp", "expert2_tp") else 1
    got = _lines(os.path.join(root, mesh))
    _close(got, _lines(os.path.join(root, f"single_align{bsz}")), TOL)
    _close(got, jax_metrics[bsz], TOL)
    with open(os.path.join(root, mesh, "run_info.json")) as f:
        info = json.load(f)
    assert info["optimizer_updates"] == STEPS // ACCUM
    assert info["mesh"] == dict(data=1, fsdp=2 if mesh == "fsdp2_tp" else 1,
                                expert=2 if mesh == "expert2_tp" else 1,
                                tensor=2, pipe=1)
    assert got[0]["loss/moe_balance"] > 0
    _weights_close(root, _state(os.path.join(root, mesh)),
                   _state(os.path.join(root, f"single_align{bsz}")))


@pytest.mark.parametrize("stage,name,rows", [
    ("pretrain", "tp_pretrain", 1), ("pretrain", "tp_pretrain_nosp", 1),
    ("pretrain", "fsdp2_tp_pretrain", 2), ("dpo", "tp_dpo", 1),
    ("dpo", "tp_dpo_nosp", 1), ("dpo", "expert2_tp_dpo", 2)])
def test_tensor_parallel_stage_1_and_3_match_single_process(runs, stage,
                                                            name, rows):
    """Stage 1 (projector only) and stage 3 (kto_pair) at (tensor=2, SP),
    (tensor=2), (fsdp=2, tensor=2) and (expert=2, tensor=2) against the
    single-process port on the same rows (which
    tests/test_torch_pretrain_dpo_step.py holds to the JAX steps)."""
    root, _ = runs
    got = _lines(os.path.join(root, name))
    want = _lines(os.path.join(root, f"single_{stage}{rows}"))
    keys = (("loss", "loss/lm", "num_tokens", "grad_norm") if stage ==
            "pretrain" else ("loss", "loss/dpo", "logps/chosen",
                             "logps/rejected", "rewards/margins",
                             "loss/moe_balance", "grad_norm"))
    _close(got, want, TOL, keys)
    _weights_close(root, _state(os.path.join(root, name)),
                   _state(os.path.join(root, f"single_{stage}{rows}")))


@pytest.mark.parametrize("name", ["tp_sp", "tp_adafactor"])
def test_replicated_parameters_are_equal_over_the_tensor_ranks(runs, name):
    """AdamW and Adafactor: after the updates both tensor ranks hold the
    same value of every parameter the tensor axis leaves whole (the
    sequence-parallel gradients of the norms and routers summed)."""
    root, _ = runs
    a, b = (torch.load(os.path.join(root, f"{name}_replicas{r}.pt"),
                       weights_only=True) for r in (0, 1))
    assert a.keys() == b.keys() and any("router" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if name == "tp_adafactor":
        _close(_lines(os.path.join(root, name)),
               _lines(os.path.join(root, "single_adafactor1")), TOL)


def test_tensor_parallel_checkpoint_resumes_update_2(runs):
    root, _ = runs
    whole = os.path.join(root, "resume_tp_whole")
    cut = os.path.join(root, "resume_tp_cut")
    with open(os.path.join(whole, f"checkpoint-{ACCUM}", "mesh.json")) as f:
        assert json.load(f)["mesh"]["tensor"] == 2
    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    assert info["resumed_from"].endswith(f"checkpoint-{ACCUM}")
    assert info["microbatches"] == STEPS - ACCUM
    a, b = _lines(whole)[ACCUM:], _lines(cut)
    assert [ln["step"] for ln in b] == [ln["step"] for ln in a]
    for x, y in zip(a, b):
        for k in METRICS:
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)
    _weights_close(root, _state(cut), _state(whole), tol=1e-6)


def test_tensor_parallel_model_pt_is_the_single_process_format(runs):
    root, _ = runs
    cfg, model = builder.load_model(os.path.join(root, "tp_sp"),
                                    device="cpu")
    want = _state(os.path.join(root, "single_align1"))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
    assert got["llm.layers.0.attn.wq"].shape[1] == 4 * 16     # all heads
    assert got["llm.lm_head.weight"].shape[0] == 512           # all vocab


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("num_heads", 6), ("num_kv_heads", 3), ("intermediate_size", 130),
    ("vocab_size", 510)])
def test_tensor_parallel_refuses_what_tensor_does_not_divide(field, value):
    from llavamod_tpu_torch.models.llm.config import tiny_config
    from llavamod_tpu_torch.parallel.sharding import check_tensor_parallel

    kw = {field: value}
    if field == "num_heads":
        kw["num_kv_heads"] = 2
    check_tensor_parallel(tiny_config(), 2)
    with pytest.raises(ValueError, match=field):
        check_tensor_parallel(tiny_config(**kw), 2 if field == "num_kv_heads"
                              else 4)


def test_sequence_parallel_refuses_t_that_tensor_does_not_divide():
    from llavamod_tpu_torch.parallel.collectives import split_seq

    class Ctx:
        tensor_size, tensor_rank, tensor_group = 2, 0, None

    with pytest.raises(ValueError, match="T % tensor"):
        split_seq(torch.zeros(1, 5, 4), Ctx())


@pytest.mark.parametrize("flag", ["fused_update", "lora_enable"])
def test_fused_update_and_lora_stay_refused_under_torch_distributed(
        flag, monkeypatch):
    """Items 14 and 15 are ported: under a torchrun environment of 2 at
    (tensor=2, SP) `refuse_unported` lets --fused_update and --lora_enable
    through (tests/test_torch_{fused,lora}_distributed.py run them), and
    --pipeline_parallel 2 too (tests/test_torch_pipeline.py runs it), LoRA
    with it; the fused step under the pipeline is the JAX engine's
    ValueError."""
    from llavamod_tpu_torch.train.args import ModelArgs, TrainArgs
    from llavamod_tpu_torch.train.run import refuse_unported

    monkeypatch.setenv("WORLD_SIZE", "2")
    margs = ModelArgs(lora_enable=flag == "lora_enable")
    targs = TrainArgs(output_dir="unused", tensor_parallel=2,
                      sequence_parallel=True,
                      fused_update=flag == "fused_update")
    refuse_unported(margs, targs)
    refuse_unported(ModelArgs(), TrainArgs(output_dir="unused",
                                           tensor_parallel=2,
                                           sequence_parallel=True))
    piped = TrainArgs(output_dir="unused", pipeline_parallel=2,
                      fused_update=flag == "fused_update")
    if flag == "fused_update":
        with pytest.raises(ValueError, match="cannot run under "
                           "--pipeline_parallel; drop one of the two"):
            refuse_unported(margs, piped)
    else:
        refuse_unported(margs, piped)


def test_generation_under_a_tensor_split_is_refused(runs):
    """Item 16 is ported: attention with a KV cache under a tensor split
    (a prefill of 12 tokens into a cache of the rank's KV heads, then one
    decode token through K2's plain version) equals the unsplit op on the
    same cache slots, and the rank's cache holds its half of every layer's
    KV heads."""
    root, _ = runs
    with open(os.path.join(root, "op_checks.json")) as f:
        got = json.load(f)
    assert got["cache_heads"] is True
    assert got["attention_cache"] <= OP_TOL, got["attention_cache"]
