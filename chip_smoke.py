"""Bring-up check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; exits non-zero without them.  It

  1. builds the hand-written kernels (llavamod_tpu_torch/csrc) from source,
     one nvcc per source, all at once;
  2. fails if ptxas reports a register spill or a serialised wgmma in any
     kernel; holds each kernel against its plain PyTorch version on the
     card, in bf16, at the shapes the serving and training paths give it
     (K1 at the student's and the teacher's training shapes and the serving
     prefill; K2 at the serving batch and the streamed request's B=1),
     under the elementwise tolerance of llavamod_tpu_torch/ops/tolerance.py;
     checks that K2, K3 and K4 give the same bits over two launches; and
     times the kernel, the plain version and one PyTorch library call
     computing the same function (scaled_dot_product_attention and its
     backward), beside the least time the card could take (bound).  A time
     (`ms`) is the device time of one call, every kernel it launches, from
     torch.profiler; `event_ms` is the CUDA-event window around one call
     from an idle card (host enqueue included, the measure of earlier runs)
     and `host_ms` the wrapper's host time;
  3. W8A8 GEMM phase: every int8 product of the int8 paths at its shapes
     (the Qwen1.5-7B teacher's wqkv, wo, gate_up and down at T=2048, an
     8192-row head chunk at the teacher's and the student's width, the
     student's experts at training capacity, a decode step at B=8 padded
     to 17 rows) through `int8_matmul` (torch._int_mm) on random int8
     operands, bitwise against the f64 product; device times of the whole
     W8A8 `dense` split into quantize, int8 product and rescale, against
     the bf16 torch.mm of the same shape and the int8 bound 2MKN / peak,
     and of the int8 product on an N-major weight (the layout decision);
  4. serving path: builds the LLaVA-MoD-2B student at full width
     (Qwen1.5-1.8B with 4 experts top-2 on the even layers, CLIP-ViT-L/336,
     mlp2x_gelu) from seeded random weights directly on the card, serves 8
     concurrent image requests plus one streamed request through the port's
     HTTP server, and checks that every served prefill went through kernel
     K1 and every decode step through kernel K2; checks the prefill's
     last-position logits against the plain attention, times prefill and
     decode, and profiles one decode step (device time of K2 by name).
     Then the same student quantized for serving (`--quant int8`:
     attention, MLP, experts, head, embedding in int8) does all of that
     again, and its prefill logits and greedy tokens are held against the
     bf16 engine's; peak device memory of each;
  5. training path: upcycles a fresh dense student to the same MoE, builds
     the Qwen1.5-7B teacher (sharing the student's frozen tower), and runs
     the stage-2 distillation step (`make_align_step`, kd_lm, record train
     set, AdamW) at B=1, T=2048: one step through plain attention from a
     fresh state as the reference; then the bf16 step and the step with
     the stage-2 config's int8 options (an int8_head copy of the teacher,
     the student head pre-quantized) in turns on the same batch, a warm-up
     and timed steps each, every one launching K1 once per student and
     teacher layer and K3 and K4 once per student layer; the first int8
     step is held against the first bf16 step, and the teacher forward is
     timed in both forms; one more step of each is profiled.  Last, 2 steps
     of the router-only `policy_body_quant` recipe: the student body in
     int8, the routers trained through the straight-through backward, every
     other weight bitwise unchanged;
  6. stages: the trainer entry point (`train/run.py::run_stage`) through
     the paper's three stages at full width, from the repository's stage
     configs as written, chained through checkpoint directories in a
     temporary directory (removed at the end whatever happens): a seeded
     dense LLaVA-Qwen1.5-1.8B and a Qwen1.5-7B teacher without a tower,
     written in bf16 with `save_model`; seeded 336x336 PNGs and three JSON
     datasets in the reference formats, read through a stand-in tokenizer;
     stage 1 (projector only, B=8, accumulation 2) -> stage 2 (upcycled to
     4 experts top-2 inside the stage, kd_lm against the teacher in W8A8
     with an int8 head, the student head pre-quantized, record train set,
     B=1, accumulation 2) -> stage 3 (kto_pair against the teacher, the
     whole LLM trainable, one pair, accumulation 2), 4 microbatches each.
     Per stage it checks that every logged metric is finite, that the
     optimizer took 2 updates, that every microbatch launched K1, K3 and K4
     as the stage's layers and remat require, and that the first
     microbatch agrees with the same step through plain attention; stage 1
     must leave every decoder and tower weight bitwise unchanged and write
     a loadable mm_projector.bin, stage 2 must shrink its teacher, write
     an MoE model and save the float student head bitwise as it came, and
     stage 3 must train it.

Prints the kernels' JSON line before the last and, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises (exit code 1).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# tolerances, stated before the run:
#  * kernels vs plain versions in bf16: elementwise |a - b| <= 2e-2 + 8e-3
#    |b| (llavamod_tpu_torch/ops/tolerance.py, shared with the gpu-marked
#    tests): both accumulate in f32, but the probabilities are rounded to
#    bf16 before P.V against differently normalised running maxima (online
#    vs one-shot softmax), and the output is rounded to bf16, so an entry's
#    own magnitude adds up to two bf16 roundings (2 x 2^-8);
TOL_TEXT = "|a-b| <= 2e-2 + 8e-3|b|"
#  * full-model prefill logits, kernel path vs plain path: 24 bf16 layers of
#    random weights amplify the kernels' rounding differences; the check is
#    on the max abs difference relative to the logits' max magnitude.
LOGITS_REL_TOL = 5e-2
#  * first training step, kernel path vs plain attention (same weights,
#    batch and fresh state): the loss is a mean over 1,471 tokens and moves
#    little with rounding; the gradient norm sums the rounding of 2 B
#    gradient entries through 24 bf16 layers and top-2 routing, whose
#    choices can flip on near ties.
LOSS_REL_TOL = 2e-2
GRAD_NORM_REL_TOL = 5e-2

#  * the int8 W8A8 path against bf16 (same weights and inputs): W8A8
#    quantizes every activation row and weight column to 127 levels, which
#    moves the teacher's logits, hence the distillation loss, by about 1e-2
#    relative; the gradient norm sums that over 2 B entries and top-2
#    routing flips; the serving logits move through 24 int8 layers and an
#    int8 head: each product re-quantizes its input rows (steps of ~1% of a
#    row's range), which also turns a bf16 rounding difference upstream
#    (the attention paths) into whole int8 steps, so the int8 engine's
#    logits are held at 0.25 of the largest logit, against the bf16 engine
#    and between its own attention paths (a broken int8 path is off by
#    ~1); greedy tokens may flip where the top two logits are close
#    (random weights leave margins of ~0.2 on logits of std ~1), so the
#    first token must agree in at least half the rows.
INT8_LOSS_REL_TOL = 5e-2
INT8_GRAD_NORM_REL_TOL = 0.2
INT8_LOGITS_REL_TOL = 0.25
INT8_FIRST_TOKEN_MIN_ROWS = 4

# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor-core rates
# and HBM3 bandwidth, for the bound each kernel is set against
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

MAX_BATCH = 8
PROMPT_LEN = 1024
NEW_TOKENS = 32
SEED = 0
TRAIN_T = 2048
TRAIN_TIMED_STEPS = 3
RECORD_TRAIN_SET = ("/gate", "/up", "/down", "router")
ATTENTION_KERNELS = ("flash_fwd", "flash_decode", "flash_dq", "flash_dkv")
STAGE_CONFIGS = (("pretrain", "configs/pretrain_qwen2_0_5b.json"),
                 ("align", "configs/dense2sparse_qwen2_0_5b.json"),
                 ("dpo", "configs/preference_qwen2_0_5b.json"))
STAGE_MICROBATCHES = 4
STAGE_ACCUM = 2
STAGE_IMAGES = 8
QWEN_REGULAR_IDS = 151_646     # ids below the Qwen vocab's special tokens
# the W8A8 products of the int8 paths (name, M, K, N): the Qwen1.5-7B
# teacher's fused layer products at T=2048, one 8192-row head chunk against
# the teacher's and the student's width, the student's experts at training
# capacity (2048 tokens x top-2 x 1.5 / 4 experts), a decode step at B=8
INT8_GEMM_SHAPES = (
    ("teacher wqkv", 2048, 4096, 12288),
    ("teacher wo", 2048, 4096, 4096),
    ("teacher gate_up", 2048, 4096, 22016),
    ("teacher down", 2048, 11008, 4096),
    ("teacher head chunk", 2048, 4096, 8192),
    ("student head chunk", 2048, 2048, 8192),
    ("student expert up/gate", 1536, 2048, 5504),
    ("student expert down", 1536, 5504, 2048),
    ("decode wqkv B=8 (padded)", 8, 2048, 6144),
)
BODY_QUANT_STEPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of one fn() each (ms), every call from
    an idle card: the window holds the host's enqueue as well."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_window(fn):
    """Run fn() once under torch.profiler; returns (wall ms, [(CUDA kernel
    name, device ms, count)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall_ms, rows


def device_ms(fn, calls: int = 20) -> float:
    """Mean device time of one fn() (ms): every CUDA kernel it launches,
    summed, from torch.profiler over `calls` calls after a warm-up; CUDA
    events over the same run of calls where three profiler windows in a
    row see no device time."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, rows = profile_window(lambda: [fn() for _ in range(calls)])
        busy = sum(r[1] for r in rows)
        if busy > 0:
            return busy / calls
    log("[kernel] the profiler recorded no device time: CUDA events over "
        f"{calls} calls instead")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_ms(fn, calls: int = 20) -> float:
    """Host time of one fn() (ms): what the caller's thread spends to
    enqueue it, over `calls` calls that do not wait for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return per_call


def timings(fn, calls: int = 20) -> dict:
    """The kernel's device time per call (`ms`), the single-call event
    window of earlier runs (`event_ms`: host enqueue plus device) and the
    wrapper's host time (`host_ms`)."""
    return dict(ms=device_ms(fn, calls), event_ms=time_ms(fn),
                host_ms=host_ms(fn, calls))


def kernel_family(name: str):
    """The wrapper whose kernel a CUDA kernel name belongs to, or None."""
    for k, wrapper in (("flash_fwd_kernel", "flash_fwd"),
                       ("flash_decode_split_kernel", "flash_decode"),
                       ("flash_decode_combine_kernel", "flash_decode"),
                       ("flash_dq_kernel", "flash_dq"),
                       ("flash_dkv_kernel", "flash_dkv")):
        if k in name:
            return wrapper
    return None


def registers_by_kernel(build_log: str) -> dict:
    """Most registers a thread of any instantiation of each wrapper's
    kernels uses (ptxas -v in the build log)."""
    regs, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = kernel_family(line)
        elif "Used" in line and "registers" in line and current:
            n = int(line.split("Used")[1].split("registers")[0])
            regs[current] = max(regs.get(current, 0), n)
    return regs


def left_pad_segments(lengths, total: int, dev) -> torch.Tensor:
    seg = torch.zeros((len(lengths), total), dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        seg[i, total - n:] = 1
    return seg


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def bound(flops: float, moved: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor peak and the bytes over the HBM peak."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = moved / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def pair_mask(seg) -> torch.Tensor:
    """[B, T, T] bool: the (query, key) pairs that attend under causal
    self-attention with segment ids `seg`."""
    from llavamod_tpu_torch.ops.flash_attention import live_pairs

    t = seg.shape[1]
    return live_pairs(seg, seg, t, t, True, seg.device)


def n_pairs(seg) -> int:
    return int(pair_mask(seg).sum().item())


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def check_flash_fwd(gen, dev):
    """K1 against its plain version; the timed cases carry their SDPA time
    and bound.  Returns the student training case (the kernels line's
    numbers) with every timed case under `by_shape`."""
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )
    from llavamod_tpu_torch.ops.tolerance import max_abs_err, tol_ratio

    cases = [  # name, B, T, H, KH, D, softcap, valid lengths
        ("train step", 1, TRAIN_T, 16, 16, 128, None, [TRAIN_T]),
        ("teacher train step", 1, TRAIN_T, 32, 32, 128, None, [TRAIN_T]),
        ("serving prefill", 8, PROMPT_LEN, 16, 16, 128, None,
         [1024, 900, 777, 640, 513, 300, 129, 1]),
        ("gqa", 2, 512, 14, 2, 64, None, [512, 200]),
        ("softcap", 2, 256, 16, 16, 128, 50.0, [256, 77]),
    ]
    timed = {}
    for name, b, t, h, kh, d, cap, lengths in cases:
        q = torch.randn((b, t, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, t, kh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, t, kh, d), generator=gen, device=dev).bfloat16()
        seg = left_pad_segments(lengths, t, dev)
        o, lse = flash_fwd(q, k, v, seg, seg, causal=True, softcap=cap)
        o_ref, lse_ref = flash_fwd_reference(q, k, v, seg, seg, causal=True,
                                             softcap=cap)
        torch.cuda.synchronize()
        real = seg.bool()                                  # [B, T]
        err = max_abs_err(o[real], o_ref[real])
        lse_real = lse.permute(0, 2, 1)[real]
        lse_ref_real = lse_ref.permute(0, 2, 1)[real]
        lse_err = max_abs_err(lse_real, lse_ref_real)
        ratio = max(tol_ratio(o[real], o_ref[real]),
                    tol_ratio(lse_real, lse_ref_real))
        pad_zero = bool((o[~real] == 0).all().item()) if (~real).any() else True
        tk = timings(lambda: flash_fwd(q, k, v, seg, seg, causal=True,
                                       softcap=cap))
        plain_ms = device_ms(lambda: flash_fwd_reference(
            q, k, v, seg, seg, causal=True, softcap=cap), calls=5)
        log(f"[kernel] flash_fwd {name}: B={b} T={t} H={h} KH={kh} D={d} "
            f"softcap={cap} max_abs_err={err:.3e} lse_err={lse_err:.3e} "
            f"worst err/tol {ratio:.3f} ({TOL_TEXT}) pad_rows_zero={pad_zero} "
            f"kernel {tk['ms']:.4f} ms (one-call event window "
            f"{tk['event_ms']:.4f}, host {tk['host_ms']:.4f}) plain "
            f"{plain_ms:.4f} ms")
        if not (ratio <= 1.0 and pad_zero):
            raise AssertionError(f"flash_fwd {name} disagrees with its plain "
                                 f"version: err {err} lse_err {lse_err} "
                                 f"err/tol {ratio} pad_zero {pad_zero}")
        if cap is None and h == kh:
            # the library call: SDPA with the same causal + segment mask
            # (the causal flag alone where no row is padded)
            mask = None if real.all() else pair_mask(seg)[:, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = timings(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None))
            timed[name] = dict(max_abs_err=err, **tk, plain_ms=plain_ms,
                               library_ms=lib["ms"],
                               library_event_ms=lib["event_ms"],
                               **bound(4 * d * h * n_pairs(seg),
                                       nbytes(q, k, v, o, lse, seg, seg)))
            log(f"[kernel] flash_fwd {name}: library "
                f"scaled_dot_product_attention {lib['ms']:.4f} ms (event "
                f"window {lib['event_ms']:.4f}), bound "
                f"{timed[name]['bound_ms']:.4f} ms "
                f"({timed[name]['bound_by']}), kernel / library "
                f"{tk['ms'] / lib['ms']:.2f}x")
    return dict(timed["train step"], by_shape=timed)


def _quant(x):
    amax = x.float().abs().amax(dim=-1)
    s = (amax / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def check_flash_decode(gen, dev):
    """K2 against its plain version; the serving case (B=8) and the
    streamed request's (B=1) carry their SDPA time and bound.  Returns the
    B=8 case with both timed cases under `by_shape`."""
    from llavamod_tpu_torch.ops.decode_attention import (
        decode_splits,
        flash_decode,
        flash_decode_reference,
    )
    from llavamod_tpu_torch.ops.tolerance import max_abs_err, tol_ratio

    s_len = PROMPT_LEN + NEW_TOKENS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [  # name, B, H, KH, D, int8, timed against SDPA
        ("serving decode bf16", 8, 16, 16, 128, False, True),
        ("streamed decode bf16", 1, 16, 16, 128, False, True),
        ("serving decode int8", 8, 16, 16, 128, True, False),
        ("gqa", 4, 14, 2, 64, False, False),
    ]
    timed = {}
    for name, b, h, kh, d, quant, vs_library in cases:
        q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, kh, s_len, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, kh, s_len, d), generator=gen, device=dev).bfloat16()
        filled = PROMPT_LEN + 7                       # slots written so far
        lengths = [filled - 3 * i * 37 for i in range(b)]
        seg = left_pad_segments(lengths, filled, dev)
        seg = torch.cat([seg, torch.zeros((b, s_len - filled), dtype=torch.int32,
                                          device=dev)], dim=1)
        kw = {}
        if quant:
            k, ks = _quant(k)
            v, vs = _quant(v)
            kw = dict(k_scale=ks, v_scale=vs)
        out = flash_decode(q, k, v, kv_seg=seg, **kw)
        ref = flash_decode_reference(q, k, v, kv_seg=seg, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        ratio = tol_ratio(out, ref)
        # the splits' partials merge in a fixed order, without atomics
        same_bits = bool(torch.equal(out, flash_decode(q, k, v, kv_seg=seg,
                                                       **kw)))
        splits = decode_splits(b, kh, s_len, sms)
        tk = timings(lambda: flash_decode(q, k, v, kv_seg=seg, **kw))
        plain_ms = device_ms(lambda: flash_decode_reference(
            q, k, v, kv_seg=seg, **kw))
        log(f"[kernel] flash_decode {name}: B={b} H={h} KH={kh} D={d} "
            f"S={s_len} splits={splits} max_abs_err={err:.3e} worst err/tol "
            f"{ratio:.3f} ({TOL_TEXT}) bitwise equal over two launches="
            f"{same_bits} kernel {tk['ms']:.4f} ms (one-call event window "
            f"{tk['event_ms']:.4f}, host {tk['host_ms']:.4f}) plain "
            f"{plain_ms:.4f} ms")
        if not (ratio <= 1.0 and same_bits):
            raise AssertionError(f"flash_decode {name} disagrees with its "
                                 f"plain version or itself: err {err} "
                                 f"deterministic {same_bits}")
        if vs_library:
            live = int((seg != 0).sum().item())     # cache slots read
            qt = q[:, :, None]
            mask = (seg != 0)[:, None, None, :]
            lib = timings(lambda: F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask, enable_gqa=h != kh))
            timed[name] = dict(max_abs_err=err, **tk, plain_ms=plain_ms,
                               library_ms=lib["ms"],
                               library_event_ms=lib["event_ms"],
                               splits=splits, deterministic=same_bits,
                               **bound(4 * d * h * live,
                                       nbytes(q, out, seg)
                                       + 2 * live * kh * d * k.element_size()))
            log(f"[kernel] flash_decode {name}: library "
                f"scaled_dot_product_attention {lib['ms']:.4f} ms (event "
                f"window {lib['event_ms']:.4f}), bound "
                f"{timed[name]['bound_ms']:.4f} ms "
                f"({timed[name]['bound_by']}, {live} live slots of "
                f"{b * s_len}), kernel / library {tk['ms'] / lib['ms']:.2f}x")
    return dict(timed["serving decode bf16"], by_shape=timed)


def check_flash_bwd(gen, dev):
    """K3 (dq) and K4 (dk, dv) against `flash_bwd_reference`; the plain
    time of each is that of its own plain version."""
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_bwd_reference,
        flash_dkv,
        flash_dkv_reference,
        flash_dq,
        flash_dq_reference,
        flash_fwd,
    )
    from llavamod_tpu_torch.ops.tolerance import max_abs_err, tol_ratio

    cases = [  # name, B, T, H, KH, D, softcap, valid lengths
        ("train step", 1, TRAIN_T, 16, 16, 128, None, [TRAIN_T]),
        ("gqa", 2, 512, 14, 2, 64, None, [512, 200]),
        ("softcap", 2, 256, 16, 16, 128, 50.0, [256, 77]),
        ("left pad", 2, 1024, 16, 16, 128, None, [1024, 333]),
    ]
    main = None
    for name, b, t, h, kh, d, cap, lengths in cases:
        q, do = (torch.randn((b, t, h, d), generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((b, t, kh, d), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        seg = left_pad_segments(lengths, t, dev)
        kw = dict(causal=True, softcap=cap)
        o, lse = flash_fwd(q, k, v, seg, seg, **kw)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, do, lse, delta, seg, seg)
        dq = flash_dq(*args, **kw)
        dk, dv = flash_dkv(*args, **kw)
        dq_ref, dk_ref, dv_ref = flash_bwd_reference(q, k, v, o, lse, do, seg,
                                                     seg, **kw)
        torch.cuda.synchronize()
        dq_err = max_abs_err(dq, dq_ref)
        dkv_err = max(max_abs_err(dk, dk_ref), max_abs_err(dv, dv_ref))
        ratio = max(tol_ratio(dq, dq_ref), tol_ratio(dk, dk_ref),
                    tol_ratio(dv, dv_ref))
        # K3 and K4 sum in a fixed order without atomics: a second launch
        # on the same inputs gives the same bits
        same_dq = bool(torch.equal(dq, flash_dq(*args, **kw)))
        dk2, dv2 = flash_dkv(*args, **kw)
        same_dkv = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        pad = ~seg.bool()
        pad_zero = bool((dq[pad] == 0).all() and (dk[pad] == 0).all()
                        and (dv[pad] == 0).all())
        t_dq = timings(lambda: flash_dq(*args, **kw))
        t_dkv = timings(lambda: flash_dkv(*args, **kw))
        plain_dq = device_ms(lambda: flash_dq_reference(*args, **kw), calls=5)
        plain_dkv = device_ms(lambda: flash_dkv_reference(*args, **kw),
                              calls=5)
        log(f"[kernel] flash_dq / flash_dkv {name}: B={b} T={t} H={h} KH={kh} "
            f"D={d} softcap={cap} max_abs_err dq {dq_err:.3e} dk,dv "
            f"{dkv_err:.3e} worst err/tol {ratio:.3f} ({TOL_TEXT}) "
            f"pad_rows_zero={pad_zero} bitwise equal over two launches: dq "
            f"{same_dq} dk,dv {same_dkv}; kernel {t_dq['ms']:.4f} / "
            f"{t_dkv['ms']:.4f} ms (one-call event windows "
            f"{t_dq['event_ms']:.4f} / {t_dkv['event_ms']:.4f}, host "
            f"{t_dq['host_ms']:.4f} / {t_dkv['host_ms']:.4f}) plain "
            f"{plain_dq:.4f} / {plain_dkv:.4f} ms")
        if not (ratio <= 1.0 and pad_zero and same_dq and same_dkv):
            raise AssertionError(f"flash backward {name} disagrees with its "
                                 f"plain version or itself: dq {dq_err} "
                                 f"dk/dv {dkv_err} err/tol {ratio} pad_zero "
                                 f"{pad_zero} deterministic dq {same_dq} "
                                 f"dk,dv {same_dkv}")
        if main is None:
            # the library call: the backward of SDPA (dq, dk and dv in one
            # call) on the same inputs; all segments are 1 here, so the
            # causal flag alone is the same mask
            assert not pad.any()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=h != kh)
            dot = do.transpose(1, 2)
            lib = timings(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            lib_keys = dict(library_ms=lib["ms"],
                            library_event_ms=lib["event_ms"])
            pairs = n_pairs(seg)
            main = (
                dict(max_abs_err=dq_err, **t_dq, plain_ms=plain_dq,
                     deterministic=same_dq, **lib_keys,
                     **bound(6 * d * h * pairs,
                             nbytes(q, k, v, do, lse, delta, seg, seg, dq))),
                dict(max_abs_err=dkv_err, **t_dkv, plain_ms=plain_dkv,
                     deterministic=same_dkv, **lib_keys,
                     **bound(8 * d * h * pairs,
                             nbytes(q, k, v, do, lse, delta, seg, seg, dk,
                                    dv))))
            log(f"[kernel] flash backward {name}: K3+K4 "
                f"{t_dq['ms'] + t_dkv['ms']:.4f} ms, library SDPA backward "
                f"(dq, dk, dv) {lib['ms']:.4f} ms (event window "
                f"{lib['event_ms']:.4f}), bound dq {main[0]['bound_ms']:.4f} "
                f"ms dk,dv {main[1]['bound_ms']:.4f} ms (operations)")
    return main


def check_int8_gemm(dev):
    """Every W8A8 product of the int8 paths at its shapes: `int8_matmul`
    (torch._int_mm) on random int8 operands, bitwise against the f64
    product (exact below 2^53), with the weight K-major as the port stores
    it and N-major (the JAX [in, out] layout as written) for the layout
    decision; device times of the whole W8A8 `dense` split into its
    quantize, int8 product and rescale, against the bf16 `torch.mm` of the
    same shape and the int8 bound 2MKN / peak."""
    from llavamod_tpu_torch.models.llm.decoder import dense_int8
    from llavamod_tpu_torch.ops.int8 import act_quant_rows, int8_matmul

    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    rows = []
    for name, m, k, n in INT8_GEMM_SHAPES:
        a = ri(m, k)
        w = ri(n, k).t()                         # K-major [K, N]
        w_n = w.contiguous()                     # N-major [K, N]
        ref = a.double() @ w.double()
        exact = (torch.equal(int8_matmul(a, w).double(), ref)
                 and torch.equal(int8_matmul(a, w_n).double(), ref))
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        scale = torch.rand((n,), generator=g, device=dev) * 1e-2
        wb = torch.randn((k, n), generator=g, device=dev).bfloat16()
        xq, s_x = act_quant_rows(x)
        y = int8_matmul(xq, w)
        with torch.no_grad():
            t = dict(
                quantize_ms=device_ms(lambda: act_quant_rows(x), calls=10),
                int_mm_ms=device_ms(lambda: int8_matmul(xq, w), calls=10),
                int_mm_n_major_ms=device_ms(lambda: int8_matmul(xq, w_n),
                                            calls=10),
                rescale_ms=device_ms(lambda: (y.float() * s_x * scale)
                                     .to(torch.bfloat16), calls=10),
                dense_ms=device_ms(lambda: dense_int8(x, w, scale), calls=10),
                bf16_mm_ms=device_ms(lambda: x @ wb, calls=10))
        ops = 2 * m * k * n
        row = dict(name=name, m=m, k=k, n=n, exact=exact, **t,
                   int8_bound_ms=ops / PEAK_INT8_OPS * 1e3,
                   bf16_bound_ms=ops / PEAK_BF16_FLOPS * 1e3)
        rows.append(row)
        log(f"[int8] {name} M={m} K={k} N={n}: int8_matmul bitwise equal to "
            f"the f64 product (K- and N-major weight): {exact}; device ms: "
            f"quantize {t['quantize_ms']:.4f} + _int_mm {t['int_mm_ms']:.4f} "
            f"+ rescale {t['rescale_ms']:.4f}, whole W8A8 dense "
            f"{t['dense_ms']:.4f} vs bf16 torch.mm {t['bf16_mm_ms']:.4f} "
            f"({t['dense_ms'] / t['bf16_mm_ms']:.2f}x); _int_mm on the N-major "
            f"weight {t['int_mm_n_major_ms']:.4f} "
            f"({t['int_mm_n_major_ms'] / t['int_mm_ms']:.1f}x K-major); int8 "
            f"bound {row['int8_bound_ms']:.4f}, bf16 bound "
            f"{row['bf16_bound_ms']:.4f}")
        del a, w, w_n, ref, x, wb, xq, y
        if not exact:
            raise AssertionError(f"int8_matmul {name} is not exact")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

class SyntheticTokenizer:
    """Deterministic synthetic ids in and out (the card's machine has no
    tokenizer files; tokenization is not the subject here)."""
    pad_token_id = 0
    eos_token_id = None

    def __init__(self, max_ids: int):
        self.max_ids = max_ids

    def __call__(self, text):
        rng = np.random.RandomState(zlib.crc32(text.encode()))
        return types.SimpleNamespace(
            input_ids=rng.randint(10, 1000, self.max_ids).tolist())

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def build_model(dev):
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import (
        QWEN1_5_1_8B,
        moe_layer_indices,
    )
    from llavamod_tpu_torch.models.vision.vit import CLIP_VIT_L_336

    llm = QWEN1_5_1_8B.replace(
        moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.5,
        moe_eval_capacity_factor=2.0, moe_min_capacity=4,
        moe_layers=moe_layer_indices("sparse", QWEN1_5_1_8B.num_layers))
    cfg = LlavaConfig(llm=llm, vision=CLIP_VIT_L_336,
                      projector_type="mlp2x_gelu", max_images=1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        model = llava.init(cfg, gen, device=dev, dtype=torch.bfloat16)
        # the fresh-init router is zero, which sends every token to experts
        # 0 and 1: fill it with seeded values so routing is exercised
        for i in cfg.llm.moe_layers:
            r = model.llm.layers[i].mlp.router
            r.copy_(torch.randn(r.shape, generator=gen, device=dev)
                    * cfg.llm.hidden_size ** -0.5)
    n_params = sum(p.numel() for p in model.parameters())
    return cfg, model, n_params


def post(url: str, payload: dict, timeout: float = 600):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def png_b64(seed: int) -> str:
    import base64
    import io

    from PIL import Image

    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 256, (336, 336, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def serve_phase(cfg, model, card: str, tag: str = "[serve]"):
    from http.server import ThreadingHTTPServer

    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.models.builder import make_image_preprocessor
    from llavamod_tpu_torch.ops.decode_attention import flash_decode
    from llavamod_tpu_torch.ops.flash_attention import flash_fwd
    from llavamod_tpu_torch.serve.server import BatchingEngine, make_handler

    runner = VQARunner(model=model, tokenizer=SyntheticTokenizer(64),
                       image_preprocessor=make_image_preprocessor(cfg),
                       template_name="qwen", max_prompt_len=PROMPT_LEN)
    engine = BatchingEngine(runner, max_batch=MAX_BATCH, batch_window=0.5,
                            default_max_new=NEW_TOKENS)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_handler(engine, "llavamod-2b-moe"))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        images = [png_b64(i) for i in range(MAX_BATCH + 1)]
        # warm-up: one request (first cuBLAS/cuDNN use, kernel library load)
        code, _, _ = post(url, {"prompt": "warm up", "image": images[0],
                                "max_new_tokens": 2})
        if code != 200:
            raise AssertionError(f"warm-up request failed: HTTP {code}")

        layers = cfg.llm.num_layers
        batches0 = engine.stats["batches"]
        flash_fwd.launches = 0
        flash_decode.launches = 0
        results = [None] * MAX_BATCH

        def fire(i):
            results[i] = post(url, {"prompt": f"What is in image {i}?",
                                    "image": images[i],
                                    "max_new_tokens": NEW_TOKENS})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(MAX_BATCH)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        t_batch = time.perf_counter() - t0
        stream = post(url, {"prompt": "Describe the image.",
                            "image": images[MAX_BATCH],
                            "max_new_tokens": NEW_TOKENS, "stream": True})
        fwd_n, dec_n = flash_fwd.launches, flash_decode.launches
        batches = engine.stats["batches"] - batches0

        n_img = cfg.num_image_tokens
        for i, res in enumerate(results):
            if res is None:
                raise AssertionError(f"request {i} did not finish")
            code, _, body = res
            out = json.loads(body)
            usage = out.get("usage", {})
            if not (code == 200 and isinstance(out.get("text"), str)
                    and 0 < usage.get("completion_tokens", 0) <= NEW_TOKENS
                    and usage.get("prompt_tokens", 0) > n_img):
                raise AssertionError(f"request {i}: HTTP {code} {out}")
        code, ctype, body = stream
        frames = [f for f in body.decode().split("\n\n") if f.strip()]
        final = [json.loads(f[6:]) for f in frames
                 if f.startswith("data: {") and '"done"' in f]
        if not (code == 200 and ctype == "text/event-stream"
                and frames and frames[-1].strip() == "data: [DONE]"
                and len(final) == 1
                and 0 < final[0]["usage"]["completion_tokens"] <= NEW_TOKENS):
            raise AssertionError(f"stream request: HTTP {code} {body[:500]!r}")
        log(f"{tag} {MAX_BATCH} concurrent image requests + 1 streamed "
            f"request in {batches} batches: all HTTP 200 with text and usage, "
            f"SSE ends with [DONE]")

        prefills = batches
        steps = batches * (NEW_TOKENS - 1)
        log(f"{tag} launches during the served requests: flash_fwd {fwd_n} "
            f"(need >= {layers} x {prefills} prefills), flash_decode {dec_n} "
            f"(need >= {layers} x {steps} decode steps)")
        if fwd_n < layers * prefills or dec_n < layers * steps or prefills < 2:
            raise AssertionError("the served requests did not go through the "
                                 "kernels on every layer")
        log(f"{tag} 8 concurrent requests: {t_batch:.3f} s, "
            f"{MAX_BATCH / t_batch:.3f} requests/s on {card} "
            f"(includes HTTP, image preprocessing, prefill and "
            f"{NEW_TOKENS} tokens of decode)")
        return dict(launches={"flash_fwd": fwd_n, "flash_decode": dec_n},
                    requests_per_s=MAX_BATCH / t_batch, runner=runner)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def logits_and_timing(cfg, model, runner, card: str, tag: str = "[slice]",
                      logits_tol: float = LOGITS_REL_TOL):
    from llavamod_tpu_torch import generation
    from llavamod_tpu_torch.generation import GenerationConfig
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.llm import decoder

    pp = runner.image_preprocessor
    rng = np.random.RandomState(1)
    from PIL import Image

    imgs = [pp(Image.fromarray(rng.randint(0, 256, (400, 300, 3),
                                           dtype=np.uint8)))
            for _ in range(MAX_BATCH)]
    prompts = [runner.build_prompt(f"Question number {i}?", True)
               for i in range(MAX_BATCH)]
    batch = runner._encode_batch(prompts, imgs)
    with torch.inference_mode():
        seg = batch.segment_ids
        pos = torch.clamp_min(torch.cumsum(seg, dim=1) - 1, 0)
        b = batch._replace(positions=pos)
        cache = decoder.init_cache(cfg.llm, MAX_BATCH,
                                   PROMPT_LEN + NEW_TOKENS, device=runner.device)
        hk = llava.forward(model, cfg, b, cache=cache, attn_impl="fresh").hidden
        hp = llava.forward(model, cfg, b, cache=None, attn_impl="xla").hidden
        lk = llava.logits(model, cfg, hk[:, -1:])[:, 0]
        lp = llava.logits(model, cfg, hp[:, -1:])[:, 0]
        torch.cuda.synchronize()
        diff = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(lk).all().item()) and diff <= logits_tol * scale
    log(f"{tag} prefill last-position logits [{MAX_BATCH}, "
        f"{lk.shape[-1]}], kernel path vs plain attention: max abs diff "
        f"{diff:.4e}, max |logit| {scale:.4e}, rel {diff / scale:.4e} "
        f"(tol {logits_tol}), greedy argmax agreement {agree:.3f}")
    if not ok:
        raise AssertionError("kernel-path prefill logits disagree with the "
                             "plain-attention forward")

    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    greedy = generation.generate(model, batch, gcfg)

    def prefill():
        return generation._prefill(model, batch, gcfg, None)

    with torch.inference_mode():
        prefill_ms = time_ms(prefill, iters=5, warmup=1)
        # decode is host-bound and swings between runs: time 3 full decodes
        decode_s = []
        for _ in range(3):
            state = prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generation._decode_steps(model, gcfg, state, NEW_TOKENS - 1, None)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
        # one decode step under the profiler, after 4 unprofiled ones
        state = prefill()
        generation._decode_steps(model, gcfg, state, 4, None)
        wall_ms, rows = profile_window(
            lambda: generation._decode_steps(model, gcfg, state, 1, None))
    t_dec = statistics.median(decode_s)
    tok_s = MAX_BATCH * (NEW_TOKENS - 1) / t_dec
    step_ms = sorted(t * 1e3 / (NEW_TOKENS - 1) for t in decode_s)
    log(f"{tag} prefill (B={MAX_BATCH}, T={PROMPT_LEN}, tower + LLM + "
        f"head): {prefill_ms:.3f} ms (median of 5); decode {NEW_TOKENS - 1} "
        f"steps at B={MAX_BATCH}, median of 3: {t_dec * 1e3:.3f} ms, "
        f"{tok_s:.1f} tokens/s, ms/step {step_ms[0]:.3f} / {step_ms[1]:.3f} "
        f"/ {step_ms[2]:.3f} (min / median / max); on {card}")
    decode_profile = summarize_profile(f"{tag} profiled decode step",
                                       wall_ms, rows, step_ms[1])
    return dict(prefill_ms=prefill_ms, decode_tok_s=tok_s,
                decode_ms_per_step=step_ms, logits_rel=diff / scale,
                decode_profile=decode_profile, prefill_logits=lk,
                greedy=greedy)


def int8_serving(cfg, model, bf16_stats, card: str):
    """The same student quantized for serving in place (`--quant int8`:
    attention, dense MLP, experts, head and embedding in int8) answers the
    same 8 concurrent image requests; its prefill logits and greedy tokens
    are held against the bf16 engine's on the same batch."""
    from llavamod_tpu_torch.models.builder import quantize_for_serving

    t0 = time.perf_counter()
    quantize_for_serving(model)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve int8] quantize_for_serving in {time.perf_counter() - t0:.1f}"
        f" s: the model now holds {module_gib(model):.2f} GiB on the device")
    torch.cuda.reset_peak_memory_stats()
    served = serve_phase(cfg, model, card, tag="[serve int8]")
    stats = logits_and_timing(cfg, model, served.pop("runner"), card,
                              tag="[slice int8]",
                              logits_tol=INT8_LOGITS_REL_TOL)
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref, got = bf16_stats.pop("prefill_logits"), stats.pop("prefill_logits")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    g16, g8 = bf16_stats.pop("greedy"), stats.pop("greedy")
    lead = [int(np.argmin(np.append(a == b, False))) for a, b in zip(g8, g16)]
    first_ok = sum(n >= 1 for n in lead)
    stats.update(logits_rel_to_bf16=rel, leading_tokens_equal=lead,
                 first_token_rows_equal=first_ok)
    steps = {k: v["decode_profile"] for k, v in (("bf16", bf16_stats),
                                                  ("int8", stats))}
    log(f"[serve int8] prefill last-position logits, int8 vs bf16 engine: "
        f"rel max abs diff {rel:.4e} (tol {INT8_LOGITS_REL_TOL}); greedy "
        f"tokens equal from the start for {lead} of {NEW_TOKENS} per row, "
        f"first token equal in {first_ok} of {len(lead)} rows (need >= "
        f"{INT8_FIRST_TOKEN_MIN_ROWS}); decode ms/step median int8 "
        f"{stats['decode_ms_per_step'][1]:.3f} vs bf16 "
        f"{bf16_stats['decode_ms_per_step'][1]:.3f}; kernels per profiled "
        f"decode step int8 {steps['int8'] and steps['int8']['kernels']} vs "
        f"bf16 {steps['bf16'] and steps['bf16']['kernels']}; peak device "
        f"memory int8 {stats['peak_gib']:.2f} vs bf16 "
        f"{bf16_stats['peak_gib']:.2f} GiB; requests/s int8 "
        f"{served['requests_per_s']:.3f}; on {card}")
    if not (rel <= INT8_LOGITS_REL_TOL
            and first_ok >= INT8_FIRST_TOKEN_MIN_ROWS):
        raise AssertionError("the int8 engine disagrees with the bf16 one")
    return served, stats


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

def build_train_models(dev):
    """The LLaVA-MoD-2B student, upcycled from a seeded dense Qwen1.5-1.8B
    LLaVA, and the Qwen1.5-7B teacher without a tower of its own, in bf16
    on the card."""
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import QWEN1_5_1_8B, QWEN1_5_7B
    from llavamod_tpu_torch.models.llm.upcycle import upcycle
    from llavamod_tpu_torch.models.vision.vit import CLIP_VIT_L_336

    def llava_cfg(llm):
        return LlavaConfig(llm=llm, vision=CLIP_VIT_L_336,
                           projector_type="mlp2x_gelu", max_images=1)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    with torch.no_grad():
        dense_cfg = llava_cfg(QWEN1_5_1_8B)
        student = llava.init(dense_cfg, gen, device=dev, dtype=torch.bfloat16)
        moe_cfg, student.llm = upcycle(
            dense_cfg.llm, student.llm, moe_mode="sparse", num_experts=4,
            top_k=2, capacity_factor=1.5, eval_capacity_factor=2.0)
        student.cfg = cfg = dense_cfg.replace(llm=moe_cfg)
        for i in moe_cfg.moe_layers:   # zero routers tie every argmax
            r = student.llm.layers[i].mlp.router
            r.copy_(torch.randn(r.shape, generator=gen, device=dev)
                    * moe_cfg.hidden_size ** -0.5)
        teacher_cfg = llava_cfg(QWEN1_5_7B)
        teacher = llava.init(teacher_cfg, gen, device=dev,
                             dtype=torch.bfloat16, vision=False)
    return cfg, student, teacher_cfg, teacher


def train_batch(cfg, dev):
    """B=1, T=2048: one image (576 slots) after the first token, seeded text
    ids; labels masked on the image slots and the first T/4 tokens."""
    from llavamod_tpu_torch.train.steps import batch_from_arrays

    rng = np.random.RandomState(SEED)
    t, n_img, s = TRAIN_T, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(10, 1000, size=(1, t)).astype(np.int32)
    image_mask = np.zeros((1, t), bool)
    image_mask[:, 1:1 + n_img] = True
    image_pos = np.zeros((1, t), np.int32)
    image_pos[0, 1:1 + n_img] = np.arange(n_img)
    labels = np.where(image_mask, -100, ids)
    labels[:, :t // 4] = -100
    return batch_from_arrays({
        "input_ids": ids, "segment_ids": np.ones((1, t), np.int32),
        "image_mask": image_mask, "image_pos": image_pos,
        "pixels": rng.randn(1, 1, 3, s, s).astype(np.float32),
        "pixel_valid": np.ones((1, 1), bool), "labels": labels}, device=dev)


def _launch_counts():
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_dkv,
        flash_dq,
        flash_fwd,
    )
    return {"flash_fwd": flash_fwd.launches, "flash_dq": flash_dq.launches,
            "flash_dkv": flash_dkv.launches}


def _reset_launch_counts():
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_dkv,
        flash_dq,
        flash_fwd,
    )
    flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0


def summarize_profile(tag: str, wall_ms: float, rows, step_ms: float,
                      attention=ATTENTION_KERNELS):
    """Device busy time of a profiled window, its share of the window and
    of an unprofiled step (`step_ms`; the profiler's own host work slows
    the window), the top device operations, and the device time of the
    `attention` wrappers' kernels by name, wherever they rank."""
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        log(f"{tag}: no device time recorded: device busy share not measured")
        return None
    rows = sorted(rows, key=lambda r: -r[1])
    top = [dict(name=n[:80], ms=ms, share=ms / busy_ms, count=c)
           for n, ms, c in rows[:8]]
    attn = {k: dict(ms=0.0, share=0.0, count=0) for k in attention}
    for n, ms, c in rows:
        k = kernel_family(n)
        if k in attn:
            attn[k]["ms"] += ms
            attn[k]["share"] += ms / busy_ms
            attn[k]["count"] += c
    n_kernels = sum(r[2] for r in rows)
    log(f"{tag}: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms device busy (sum of "
        f"kernel times), idle share {1 - busy_ms / wall_ms:.3f} of the window "
        f"and {1 - busy_ms / step_ms:.3f} of the median unprofiled step "
        f"({step_ms:.1f} ms), {n_kernels} kernels")
    for r in top:
        log(f"{tag}   {r['ms']:9.3f} ms {r['share']:6.1%} x{r['count']:<5d} "
            f"{r['name']}")
    for k, r in attn.items():
        log(f"{tag}   attention kernel {k}: {r['ms']:.3f} ms "
            f"({r['share']:.1%} of busy) x{r['count']}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n_kernels,
                idle_share=1 - busy_ms / wall_ms,
                idle_share_unprofiled=1 - busy_ms / step_ms, top=top,
                attention_kernels=attn)


def profile_step(step, state, teacher, batch, step_ms: float,
                 tag: str = "[train] profiled step"):
    """One training step under torch.profiler (`summarize_profile`)."""
    out = {}

    def run():
        out["state"], _ = step(state, teacher, batch)

    wall_ms, rows = profile_window(run)
    return out["state"], summarize_profile(tag, wall_ms, rows, step_ms)


def module_gib(module) -> float:
    """Device bytes of a module's parameters and buffers, in GiB."""
    return sum(nbytes(t) for t in list(module.parameters())
               + list(module.buffers())) / 2**30


@contextlib.contextmanager
def swapped_head(llm, head):
    """Within the block the student's head is `head` (its int8 form); the
    float head is put back afterwards."""
    float_head = llm.lm_head.weight
    del llm.lm_head.weight
    llm.lm_head.weight = head
    try:
        yield
    finally:
        del llm.lm_head.weight
        llm.lm_head.weight = float_head


def first_step(step, student, tcfg, teacher, batch):
    """One step from a fresh state; the weights are put back afterwards.
    Returns its metrics."""
    from llavamod_tpu_torch.train.optim import TrainState

    state = TrainState.create(student, tcfg)
    saved = {n: p.detach().clone() for n, p in state.opt.params.items()}
    _, m = step(state, teacher, batch)
    out = {k: v.item() for k, v in m.items()}
    with torch.no_grad():
        for n, p in state.opt.params.items():
            p.copy_(saved[n])
    del state, saved, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def teacher_forward_ms(teacher, teacher_cfg, student, cfg, batch) -> float:
    """Device time of the teacher's forward on the batch (the step's
    teacher side before the loss), on the student's tower features."""
    from llavamod_tpu_torch.models import llava

    tb = batch._replace(pixels=batch.pixels.bfloat16())
    with torch.no_grad():
        pixels = tb.pixels.reshape((-1,) + tuple(tb.pixels.shape[2:]))
        tower = llava.encode_tower(student, cfg, pixels)
        return device_ms(lambda: llava.forward(teacher, teacher_cfg, tb,
                                               tower_feats=tower), calls=3)


def train_phase(card: str, dev):
    """The stage-2 step in bf16 and with the stage-2 config's int8 options
    (ref_quant=int8_head, policy_head_quant), alternated on one batch, then
    the router-only policy_body_quant recipe."""
    from llavamod_tpu_torch.models.llm.decoder import (
        quantize_decoder_int8,
        quantize_head_int8,
    )
    from llavamod_tpu_torch.train.config import TrainConfig
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.steps import make_align_step

    t0 = time.perf_counter()
    cfg, student, teacher_cfg, teacher = build_train_models(dev)
    torch.cuda.synchronize()
    n_s = sum(p.numel() for p in student.parameters())
    n_t = sum(p.numel() for p in teacher.parameters())
    log(f"[train] student {n_s / 1e9:.3f} B params (upcycled: experts on "
        f"layers {cfg.llm.moe_layers[0]}..{cfg.llm.moe_layers[-1]} step 2), "
        f"teacher {n_t / 1e9:.3f} B params without a tower, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(stage="align", align_loss_type="kd_lm",
                       compute_dtype="bfloat16", param_dtype="bfloat16",
                       remat=False, kd_vocab_limit=151936, vocab_chunk=2048,
                       attn_impl="auto", optimizer="adamw",
                       train_modules=RECORD_TRAIN_SET, total_steps=10_000,
                       max_grad_norm=1.0)
    batch = train_batch(cfg, dev)
    n_tok = batch.input_ids.numel()

    # the reference: the first step through plain attention, from the same
    # weights with a fresh state
    plain = first_step(make_align_step(cfg, teacher_cfg,
                                       tcfg.replace(attn_impl="xla")),
                       student, tcfg, teacher, batch)

    # the stage-2 config's int8 options: the teacher in W8A8 with an int8
    # head (a copy, quantized layer by layer), the student's frozen head
    # pre-quantized
    t0 = time.perf_counter()
    teacher8 = copy.deepcopy(teacher)
    quantize_decoder_int8(teacher8.llm, include_lm_head=True)
    with torch.no_grad():
        head8 = quantize_head_int8(student.llm.lm_head.weight)
    torch.cuda.synchronize()
    gib = {"bf16": module_gib(teacher), "int8": module_gib(teacher8)}
    log(f"[train int8] teacher quantized to W8A8 with an int8 head in "
        f"{time.perf_counter() - t0:.1f} s: {gib['bf16']:.2f} GiB in bf16 -> "
        f"{gib['int8']:.2f} GiB; student head "
        f"{module_gib(student.llm.lm_head) :.3f} -> {module_gib(head8):.3f} "
        f"GiB")
    tcfg8 = tcfg.replace(student_head_quant=True)
    step8 = make_align_step(cfg, teacher_cfg, tcfg8)
    with swapped_head(student.llm, head8):
        first8 = first_step(step8, student, tcfg8, teacher8, batch)

    state = TrainState.create(student, tcfg)
    n_train = sum(p.numel() for p in state.opt.params.values())
    step = make_align_step(cfg, teacher_cfg, tcfg)
    per_step = {"flash_fwd": cfg.llm.num_layers + teacher_cfg.llm.num_layers,
                "flash_dq": cfg.llm.num_layers,
                "flash_dkv": cfg.llm.num_layers}
    runs = {"bf16": (step, teacher, contextlib.nullcontext),
            "int8": (step8, teacher8,
                     lambda: swapped_head(student.llm, head8))}
    times = {"bf16": [], "int8": []}
    peaks = {"bf16": 0.0, "int8": 0.0}
    first = None
    _reset_launch_counts()
    for i in range(1 + TRAIN_TIMED_STEPS):
        # bf16 and int8 in turns: AB, BA, AB, BA
        for kind in (("bf16", "int8") if i % 2 == 0 else ("int8", "bf16")):
            fn, tch, ctx = runs[kind]
            before = _launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            with ctx():
                state, m = fn(state, tch, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            peaks[kind] = max(peaks[kind],
                              torch.cuda.max_memory_allocated() / 2**30)
            vals = {k: v.item() for k, v in m.items()}
            got = {k: n - before[k] for k, n in _launch_counts().items()}
            log(f"[train] step {i} {kind}: {dt * 1e3:.1f} ms loss "
                f"{vals['loss']:.5f} (align {vals['loss/align']:.5f} lm "
                f"{vals['loss/lm']:.5f} moe {vals['loss/moe_balance']:.5f}) "
                f"grad_norm {vals['grad_norm']:.5f} launches {got}")
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"step {i} {kind}: non-finite metrics "
                                     f"{vals}")
            if got != per_step:
                raise AssertionError(f"step {i} {kind} launched {got}, "
                                     f"expected {per_step} per step")
            if i == 0 and kind == "bf16":
                first = vals
            elif i > 0:
                times[kind].append(dt)
    launches = _launch_counts()

    rel = {k: abs(first[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm")}
    log(f"[train] first step, kernel path vs plain attention: loss "
        f"{first['loss']:.6f} vs {plain['loss']:.6f} (rel {rel['loss']:.3e}, "
        f"tol {LOSS_REL_TOL}), grad_norm {first['grad_norm']:.6f} vs "
        f"{plain['grad_norm']:.6f} (rel {rel['grad_norm']:.3e}, tol "
        f"{GRAD_NORM_REL_TOL})")
    rel8 = {k: abs(first8[k] - first[k]) / abs(first[k])
            for k in ("loss", "loss/align", "loss/lm", "grad_norm")}
    log(f"[train int8] first step, int8 (int8_head teacher, int8 student "
        f"head) vs bf16: loss {first8['loss']:.6f} vs {first['loss']:.6f} "
        f"(rel {rel8['loss']:.3e}, tol {INT8_LOSS_REL_TOL}; align rel "
        f"{rel8['loss/align']:.3e}, lm rel {rel8['loss/lm']:.3e}), grad_norm "
        f"{first8['grad_norm']:.6f} vs {first['grad_norm']:.6f} (rel "
        f"{rel8['grad_norm']:.3e}, tol {INT8_GRAD_NORM_REL_TOL})")
    if not (rel["loss"] <= LOSS_REL_TOL
            and rel["grad_norm"] <= GRAD_NORM_REL_TOL):
        raise AssertionError("the kernel-path training step disagrees with "
                             "the plain-attention step")
    if not (rel8["loss"] <= INT8_LOSS_REL_TOL
            and rel8["grad_norm"] <= INT8_GRAD_NORM_REL_TOL):
        raise AssertionError("the int8 training step disagrees with bf16")

    fwd_ms = {"bf16": teacher_forward_ms(teacher, teacher_cfg, student, cfg,
                                         batch),
              "int8": teacher_forward_ms(teacher8, teacher_cfg, student, cfg,
                                         batch)}
    ms = {k: sorted(t * 1e3 for t in v) for k, v in times.items()}
    med = {k: statistics.median(v) for k, v in ms.items()}
    for kind in ("bf16", "int8"):
        other = "int8" if kind == "bf16" else "bf16"
        log(f"[train] make_align_step {kind}, B=1 T={TRAIN_T}, "
            f"{n_train / 1e9:.3f} B trainable: step ms {ms[kind][0]:.1f} / "
            f"{med[kind]:.1f} / {ms[kind][-1]:.1f} (min / median / max of "
            f"{len(ms[kind])} after 1 warm-up, bf16 and int8 in turns), "
            f"{n_tok / med[kind] * 1e3:.1f} tokens/s, peak device memory "
            f"{peaks[kind]:.2f} GiB ({peaks[kind] - gib[other]:.2f} without "
            f"the {other} teacher kept for the other step), teacher forward "
            f"{fwd_ms[kind]:.2f} ms device time; on {card}")
    state, prof = profile_step(step, state, teacher, batch, med["bf16"])
    with swapped_head(student.llm, head8):
        state, prof8 = profile_step(step8, state, teacher8, batch,
                                    med["int8"], "[train int8] profiled step")
    del state, teacher, runs
    gc.collect()
    torch.cuda.empty_cache()
    body = body_quant_steps(cfg, student, teacher_cfg, teacher8, tcfg, batch,
                            per_step, card)
    return dict(step_ms=ms["bf16"], tokens_per_s=n_tok / med["bf16"] * 1e3,
                peak_gib=peaks["bf16"], trainable=n_train, launches=launches,
                first_step=first, plain_first_step=plain, rel=rel,
                profile=prof, int8=dict(
                    step_ms=ms["int8"],
                    tokens_per_s=n_tok / med["int8"] * 1e3,
                    peak_gib=peaks["int8"], teacher_gib=gib,
                    teacher_forward_ms=fwd_ms, first_step=first8,
                    rel_to_bf16=rel8, profile=prof8),
                body_quant=body)


def body_quant_steps(cfg, student, teacher_cfg, teacher8, tcfg, batch,
                     per_step, card):
    """The router-only recipe with --policy_body_quant: the student's whole
    body (experts included) in int8 through `run.quantize_stage_models`,
    only the routers train (the projector frozen), and their gradients come
    through the straight-through backward of every int8 product.  Every
    non-router weight must stay bitwise as it was."""
    from llavamod_tpu_torch.train.args import AlignArgs
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.run import quantize_stage_models
    from llavamod_tpu_torch.train.steps import make_align_step

    tcfgb = tcfg.replace(train_modules=("router",), student_body_quant=True,
                         freeze_mm_mlp_adapter=True, learning_rate=1e-3,
                         warmup_ratio=0.0)
    t0 = time.perf_counter()
    stash = quantize_stage_models(tcfgb, AlignArgs(), student, teacher8)
    torch.cuda.synchronize()
    log(f"[train body-quant] student body quantized to int8 (experts "
        f"included) in {time.perf_counter() - t0:.1f} s, float layers kept "
        f"on the host ({len(stash['layers'])}); student now "
        f"{module_gib(student):.2f} GiB")
    before = {k: v.clone() for k, v in student.state_dict().items()}
    state = TrainState.create(student, tcfgb)
    step = make_align_step(cfg, teacher_cfg, tcfgb)
    routers = {f"llm.layers.{i}.mlp.router" for i in cfg.llm.moe_layers}
    # nothing below layer 0's MoE block takes a gradient (embedding, tower
    # and projector frozen), so layer 0's attention forms no backward
    per_step = dict(per_step, flash_dq=per_step["flash_dq"] - 1,
                    flash_dkv=per_step["flash_dkv"] - 1)
    out = []
    _reset_launch_counts()
    for i in range(BODY_QUANT_STEPS):
        before_n = _launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, teacher8, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        vals = {k: v.item() for k, v in m.items()}
        got = {k: n - before_n[k] for k, n in _launch_counts().items()}
        out.append(dict(ms=dt * 1e3, **vals))
        log(f"[train body-quant] step {i}: {dt * 1e3:.1f} ms loss "
            f"{vals['loss']:.5f} grad_norm {vals['grad_norm']:.5f} (routers "
            f"only) launches {got}")
        if not (all(np.isfinite(v) for v in vals.values())
                and vals["grad_norm"] > 0 and got == per_step):
            raise AssertionError(f"body-quant step {i}: {vals} {got}")
    after = student.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    log(f"[train body-quant] after {BODY_QUANT_STEPS} steps: moved "
        f"{sorted(moved)}; {len(before) - len(moved)} other tensors bitwise "
        f"unchanged (need exactly the {len(routers)} routers to move); on "
        f"{card}")
    if moved != routers:
        raise AssertionError(f"body-quant moved {sorted(moved ^ routers)[:6]}")
    return dict(steps=out, launches=_launch_counts(), routers_moved=len(moved))


# ---------------------------------------------------------------------------
# stages phase: the trainer entry point through the paper's three stages
# ---------------------------------------------------------------------------

class StandInTokenizer:
    """A deterministic character-level stand-in for the Qwen tokenizer (the
    card's machine has no tokenizer files): one id below 151,646 per
    character, no BOS, pad id 0.  A text's ids are its pieces' ids joined,
    so the per-round label masking of data/preprocess.py lines up
    exactly."""
    pad_token_id = 0
    bos_token_id = None
    eos_token_id = None

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[
            10 + (ord(c) * 7919) % (QWEN_REGULAR_IDS - 10) for c in text])


def _words(rng, n_chars: int) -> str:
    """Seeded lower-case words, about n_chars long."""
    out, n = [], 0
    while n < n_chars:
        w = "".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 9)))
        out.append(w)
        n += len(w) + 1
    return " ".join(out)


def _real_tokens(conversation, template: str, n_img: int) -> int:
    """Real tokens of one sample after the image slots are spliced in."""
    from llavamod_tpu_torch.data.preprocess import (
        preprocess_conversations,
        preprocess_multimodal_text,
    )

    conv = preprocess_multimodal_text([conversation])
    ids = preprocess_conversations(conv, StandInTokenizer(), template).input_ids
    images = sum(1 for i in ids if i < 0)
    return len(ids) - images + images * n_img


def write_stage_data(root: str, n_img: int) -> dict:
    """Seeded 336x336 PNGs and the three datasets in the reference formats:
    stage-1 captions (LLaVA-558K style, `plain`), stage-2 multi-turn
    conversations (LLaVA-mix665k style, `qwen`), stage-3 chosen / rejected
    pairs (RLAIF-V style, `qwen`).  Every sample has 700-2,048 real tokens
    (checked here) and is padded to 2,048 by the collator."""
    from PIL import Image

    rng = np.random.RandomState(SEED + 5)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    for i in range(STAGE_IMAGES):
        Image.fromarray(rng.randint(0, 256, (336, 336, 3), dtype=np.uint8)
                        ).save(os.path.join(img_dir, f"{i}.png"))

    def human(first):
        return {"from": "human",
                "value": ("<image>\n" if first else "")
                + _words(rng, rng.randint(30, 100)) + "?"}

    def gpt(lo, hi):
        return {"from": "gpt", "value": _words(rng, rng.randint(lo, hi))}

    def sample(kind, i):
        image = f"{i % STAGE_IMAGES}.png"
        if kind == "pretrain":
            return "plain", {"id": i, "image": image, "conversations": [
                {"from": "human", "value": "<image>\n"}, gpt(200, 1200)]}
        if kind == "align":
            turns = [human(True), gpt(100, 350)]
            for _ in range(rng.randint(1, 3)):
                turns += [human(False), gpt(100, 350)]
            return "qwen", {"id": i, "image": image, "conversations": turns}
        q = human(True)
        return "qwen", {"id": i, "image": image, "chosen": [q, gpt(100, 900)],
                        "rejected": [q, gpt(100, 900)]}

    paths, lengths = {}, {}
    for kind, n in (("pretrain", 32), ("align", 8), ("dpo", 8)):
        records = []
        while len(records) < n:
            template, rec = sample(kind, len(records))
            sides = [rec["conversations"]] if "conversations" in rec else [
                rec["chosen"], rec["rejected"]]
            real = [_real_tokens(c, template, n_img) for c in sides]
            if all(700 <= r <= 2048 for r in real):
                records.append(rec)
                lengths.setdefault(kind, []).extend(real)
        paths[kind] = os.path.join(root, f"{kind}.json")
        with open(paths[kind], "w") as f:
            json.dump(records, f)
    log("[stages] data: " + ", ".join(
        f"{k} {len(v)} sequences of {min(v)}-{max(v)} real tokens"
        for k, v in lengths.items()) + f" ({STAGE_IMAGES} seeded PNGs)")
    return dict(paths, images=img_dir)


def _param_count(cfg, vision: bool = True) -> int:
    from llavamod_tpu_torch.models import llava

    model = llava.init(cfg, None, device="meta", vision=vision)
    return sum(p.numel() for p in model.parameters())


def write_stage_models(root: str, dev) -> dict:
    """The seeded dense LLaVA (Qwen1.5-1.8B, CLIP-ViT-L/336, mlp2x_gelu) and
    the Qwen1.5-7B teacher without a tower, bf16, written with `save_model`
    as a user brings checkpoints.  Fails, with the numbers, when the disk
    cannot hold them and the stages' outputs."""
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.builder import save_model
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import (
        QWEN1_5_1_8B,
        QWEN1_5_7B,
        moe_layer_indices,
    )
    from llavamod_tpu_torch.models.vision.vit import CLIP_VIT_L_336

    def cfg_of(llm):
        return LlavaConfig(llm=llm, vision=CLIP_VIT_L_336,
                           projector_type="mlp2x_gelu", max_images=1)

    dense_cfg, teacher_cfg = cfg_of(QWEN1_5_1_8B), cfg_of(QWEN1_5_7B)
    moe_cfg = cfg_of(QWEN1_5_1_8B.replace(
        moe_num_experts=4, moe_layers=moe_layer_indices("sparse", 24)))
    gb = {"dense": 2 * _param_count(dense_cfg) / 1e9,
          "teacher": 2 * _param_count(teacher_cfg, vision=False) / 1e9,
          "moe": 2 * _param_count(moe_cfg) / 1e9}
    # on disk at once, at most: the inputs with the outputs of stages 1 and
    # 2 (the dense model and stage 1's output go before stage 3)
    need = gb["dense"] * 2 + gb["teacher"] + gb["moe"] + 1.0
    free = shutil.disk_usage(root).free / 1e9
    log(f"[stages] checkpoints in {root}: dense {gb['dense']:.2f} GB, teacher "
        f"{gb['teacher']:.2f} GB, MoE student {gb['moe']:.2f} GB (bf16); at "
        f"most {need:.1f} GB on disk at once, {free:.1f} GB free")
    if free < need:
        raise AssertionError(f"the stages need {need:.1f} GB of disk in "
                             f"{root}, {free:.1f} GB are free")
    dirs, t0 = {}, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for name, cfg, vision in (("dense", dense_cfg, True),
                              ("teacher", teacher_cfg, False)):
        with torch.no_grad():
            model = llava.init(cfg, gen, device=dev, dtype=torch.bfloat16,
                               vision=vision)
        dirs[name] = save_model(os.path.join(root, name), model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[stages] built and wrote the dense LLaVA and the teacher in "
        f"{time.perf_counter() - t0:.1f} s")
    return dirs


@contextlib.contextmanager
def counted_steps(records: list):
    """Within the block, the step functions that `run_stage` makes record,
    for each microbatch, its K1/K3/K4 launches and its time (the card
    synchronised before and after)."""
    from llavamod_tpu_torch.train import steps

    names = ("make_pretrain_step", "make_align_step", "make_dpo_step")
    originals = {n: getattr(steps, n) for n in names}

    def wrap(make):
        def maker(*a, **k):
            step = make(*a, **k)

            def counted(*sa, **sk):
                before = _launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                records.append(dict(
                    ms=(time.perf_counter() - t0) * 1e3,
                    launches={k: n - before[k]
                              for k, n in _launch_counts().items()}))
                return out
            return counted
        return maker

    for n, make in originals.items():
        setattr(steps, n, wrap(make))
    try:
        yield records
    finally:
        for n, make in originals.items():
            setattr(steps, n, make)


def parse_stage(stage: str, config: str, argv: list):
    """The stage's dataclasses from the repository's config file, with the
    command line `argv` on top."""
    from llavamod_tpu_torch.train import args

    classes = [args.ModelArgs, args.DataArgs, args.TrainArgs]
    if stage == "align":
        classes.append(args.AlignArgs)
    if stage == "dpo":
        classes.append(args.DPOArgs)
    parsed = args.parse_into_dataclasses(classes, ["--config", config] + argv)
    margs, dargs, targs = parsed[:3]
    extra = parsed[3] if len(parsed) > 3 else None
    return margs, dargs, targs, extra


def plain_first_microbatch(stage, margs, dargs, targs, extra, tok, dev):
    """The stage's first microbatch through plain attention: the step that
    `run_stage` makes, on models loaded from the same directories and the
    loader's first batch, from a fresh state (with accumulation, the first
    microbatch updates nothing)."""
    from llavamod_tpu_torch.train import run, steps
    from llavamod_tpu_torch.train.args import train_config_from_args
    from llavamod_tpu_torch.train.loader import infinite_batches
    from llavamod_tpu_torch.train.optim import TrainState

    salign = extra if stage == "align" else None
    sdpo = extra if stage == "dpo" else None
    cfg, model, teacher_cfg, teacher = run.build_stage_models(
        stage, margs, targs, salign, sdpo, dev)
    batches = infinite_batches(run.build_data_module(stage, margs, dargs,
                                                     targs, tok, cfg))
    arrays = next(batches)
    batches.close()
    mods = run.translate_train_modules(margs.train_modules)
    tcfg = train_config_from_args(
        stage, targs, targs.max_steps,
        dataclasses.replace(margs, train_modules=mods), salign,
        sdpo).replace(attn_impl="xla")
    if teacher is not None and steps._can_share_tower(tcfg, cfg, teacher_cfg):
        del teacher.vision
    run.quantize_stage_models(tcfg, extra, model, teacher)
    state = TrainState.create(model, tcfg)
    if stage == "align":
        _, m = steps.make_align_step(cfg, teacher_cfg, tcfg)(
            state, teacher, steps.batch_from_arrays(arrays, device=dev))
    elif stage == "dpo":
        _, m = steps.make_dpo_step(cfg, teacher_cfg, tcfg)(state, teacher,
                                                           arrays)
    else:
        _, m = steps.make_pretrain_step(cfg, tcfg)(
            state, steps.batch_from_arrays(arrays, device=dev))
    out = {k: v.item() for k, v in m.items()}
    del state, model, teacher, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _read_json_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _num_layers(model_dir: str) -> int:
    from llavamod_tpu_torch.models.builder import CONFIG_NAME

    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        return json.load(f)["llm"]["num_layers"]


@contextlib.contextmanager
def recorded_quantization(record: dict):
    """Within the block, `run.quantize_stage_models` records the teacher's
    device GiB before and after it, and whether the student's head ended
    in int8."""
    from llavamod_tpu_torch.models.params import Int8Weight
    from llavamod_tpu_torch.train import run

    original = run.quantize_stage_models

    def recording(tcfg, stage_args, model, teacher):
        before = module_gib(teacher.llm) if teacher is not None else 0.0
        stash = original(tcfg, stage_args, model, teacher)
        record.update(
            teacher_gib_before=before,
            teacher_gib_after=(module_gib(teacher.llm) if teacher is not None
                               else 0.0),
            # float matrices left in the teacher's LLM besides its
            # embedding table (which W8A8 keeps in bf16)
            teacher_float_matrices=0 if teacher is None else sum(
                p.dim() >= 2 and n != "embed.embedding"
                for n, p in teacher.llm.named_parameters()),
            ref_quant=getattr(stage_args, "ref_quant", ""),
            student_head_int8=isinstance(model.llm.lm_head.weight,
                                         Int8Weight))
        return stash

    run.quantize_stage_models = recording
    try:
        yield record
    finally:
        run.quantize_stage_models = original


def drive_stage(stage, config, argv, tok, dev, card):
    """One stage through `run_stage` (counts set to 0 just before, read just
    after), with the plain-attention first microbatch beside it; returns
    the stage's numbers after checking them."""
    from llavamod_tpu_torch.train.run import run_stage

    margs, dargs, targs, extra = parse_stage(stage, config, argv)
    policy = (extra.policy_model_name_or_path if extra is not None
              else margs.model_name_or_path)
    layers = _num_layers(policy)
    teacher_layers = (_num_layers(extra.ref_model_name_or_path)
                      if extra is not None else 0)
    per_mb = {"flash_fwd": layers * (2 if targs.remat else 1) + teacher_layers,
              "flash_dq": layers, "flash_dkv": layers}

    t0 = time.perf_counter()
    plain = plain_first_microbatch(stage, margs, dargs, targs, extra, tok, dev)
    plain_s = time.perf_counter() - t0

    kw = {"align": dict(salign=extra), "dpo": dict(sdpo=extra)}.get(stage, {})
    records, quant = [], {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps(records), recorded_quantization(quant):
        _reset_launch_counts()
        last = run_stage(stage, margs, dargs, targs, tokenizer=tok,
                         device=dev, **kw)
        launches = _launch_counts()
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()

    out = targs.output_dir
    lines = _read_json_lines(os.path.join(out, "metrics.jsonl"))
    with open(os.path.join(out, "run_info.json")) as f:
        info = json.load(f)
    first = {k: v for k, v in lines[0].items()
             if k not in ("step", "sec_per_step")}
    finite = all(np.isfinite(v) for ln in lines for v in ln.values())
    updates = targs.max_steps // targs.gradient_accumulation_steps
    rel_keys = ["loss"] + (["logps/chosen", "logps/rejected"]
                           if stage == "dpo" else [])
    rel = {k: abs(first[k] - plain[k]) / abs(plain[k]) for k in rel_keys}
    rel["grad_norm"] = (abs(first["grad_norm"] - plain["grad_norm"])
                        / abs(plain["grad_norm"]))
    ms = [r["ms"] for r in records]
    med = statistics.median(ms[1:])
    rows = targs.per_device_train_batch_size * (2 if stage == "dpo" else 1)
    tokens = rows * targs.model_max_length
    log(f"[stages] {stage}: {len(lines)} logged microbatches, all finite: "
        f"{finite}; optimizer updates {info['optimizer_updates']} (need "
        f"{updates}); launches per microbatch "
        f"{[r['launches'] for r in records]} (need {per_mb} each)")
    log(f"[stages] {stage}: first microbatch, kernel path vs plain "
        f"attention: " + ", ".join(
            f"{k} {first[k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.3e})"
            for k in rel) + f"; tol loss/logps {LOSS_REL_TOL}, grad_norm "
        f"{GRAD_NORM_REL_TOL}")
    log(f"[stages] {stage}: microbatch ms {' / '.join(f'{t:.1f}' for t in ms)}"
        f" (median after the first {med:.1f}), {tokens / med * 1e3:.1f} "
        f"tokens/s ({rows} x {targs.model_max_length} padded), peak device "
        f"memory {peak_gib:.2f} GiB; checkpoints: load and build "
        f"{info['build_and_load_s']:.1f} s, save {info['save_s']:.1f} s; "
        f"run_stage {wall_s:.1f} s, plain reference {plain_s:.1f} s; on "
        f"{card}")
    if not (finite and len(lines) == targs.max_steps
            and info["optimizer_updates"] == updates
            and info["microbatches"] == targs.max_steps):
        raise AssertionError(f"{stage}: metrics {lines} run {info}")
    if len(records) != targs.max_steps or any(r["launches"] != per_mb
                                              for r in records):
        raise AssertionError(f"{stage}: launches {records}, need {per_mb}")
    if not (all(rel[k] <= LOSS_REL_TOL for k in rel_keys)
            and rel["grad_norm"] <= GRAD_NORM_REL_TOL):
        raise AssertionError(f"{stage}: the kernel path disagrees with plain "
                             f"attention: {rel}")
    if quant.get("ref_quant"):
        log(f"[stages] {stage}: --ref_quant {quant['ref_quant']} from the "
            f"config: teacher LLM {quant['teacher_gib_before']:.2f} GiB -> "
            f"{quant['teacher_gib_after']:.2f} GiB on the device, float "
            f"matrices left besides the embedding: "
            f"{quant['teacher_float_matrices']}; student head in int8: "
            f"{quant['student_head_int8']}")
        if (quant["teacher_float_matrices"] or not quant["student_head_int8"]
                or not quant["teacher_gib_after"]
                < quant["teacher_gib_before"]):
            raise AssertionError(f"{stage}: the int8 options did not take: "
                                 f"{quant}")
    return dict(microbatch_ms=ms, median_ms=med, tokens_per_s=tokens / med * 1e3,
                peak_gib=peak_gib, load_s=info["build_and_load_s"],
                save_s=info["save_s"], run_stage_s=wall_s,
                updates=info["optimizer_updates"], launches=launches,
                launches_per_microbatch=per_mb, first=first, plain_first=plain,
                rel=rel, last=last, quantization=quant)


def check_stage1_outputs(dense_dir: str, out: str) -> None:
    """Stage 1 moved the projector only, and its mm_projector.bin loads."""
    from llavamod_tpu_torch.train.checkpoint import load_mm_projector

    def state(d):
        return torch.load(os.path.join(d, "model.pt"), map_location="cpu",
                          weights_only=True, mmap=True)

    before, after = state(dense_dir), state(out)
    if before.keys() != after.keys():
        raise AssertionError("stage 1 changed the model's keys")
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    frozen_moved = [k for k in moved if not k.startswith("projector.")]
    proj = load_mm_projector(os.path.join(out, "mm_projector.bin"),
                             "mlp2x_gelu")
    proj_ok = all(torch.equal(v, after["projector." + k])
                  for k, v in proj.items()) and len(proj) == 4
    log(f"[stages] pretrain: {len(moved)} tensors moved (all projector: "
        f"{not frozen_moved}), {len(before) - len(moved)} decoder and tower "
        f"tensors bitwise unchanged; mm_projector.bin loads and equals the "
        f"saved projector: {proj_ok}")
    if frozen_moved or not moved or not proj_ok:
        raise AssertionError(f"stage 1 outputs: moved {frozen_moved[:4]}, "
                             f"projector file ok {proj_ok}")


def check_float_head(before_dir: str, out: str) -> None:
    """Stage 2 ran the config's policy_head_quant: its checkpoint holds the
    float student head, bitwise the head it was given (the int8 copy was a
    training-time stand-in), and no int8 tensor."""
    def state(d):
        return torch.load(os.path.join(d, "model.pt"), map_location="cpu",
                          weights_only=True, mmap=True)

    before, after = state(before_dir), state(out)
    key = "llm.lm_head.weight"
    same = torch.equal(before[key], after[key])
    int8 = [k for k in after if "w_int8" in k or k.endswith(".scale")]
    log(f"[stages] align: saved student head {tuple(after[key].shape)} "
        f"{after[key].dtype}, bitwise the input head: {same}; int8 tensors in "
        f"the checkpoint: {len(int8)}")
    if not same or int8:
        raise AssertionError(f"stage 2 checkpoint: head equal {same}, int8 "
                             f"{int8[:4]}")


def _moe_config(model_dir: str) -> dict:
    from llavamod_tpu_torch.models.builder import CONFIG_NAME

    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        llm = json.load(f)["llm"]
    return {k: llm[k] for k in ("moe_num_experts", "moe_top_k",
                                "moe_capacity_factor", "moe_layers")}


def stages_phase(card: str, dev):
    root = tempfile.mkdtemp(prefix="llavamod_stages_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        t0 = time.perf_counter()
        dirs = write_stage_models(root, dev)
        write_s = time.perf_counter() - t0
        data = write_stage_data(root, n_img=576)
        tok = StandInTokenizer()
        outs = {s: os.path.join(root, f"out_{s}") for s, _ in STAGE_CONFIGS}
        common = ["--image_folder", data["images"],
                  "--max_steps", str(STAGE_MICROBATCHES),
                  "--gradient_accumulation_steps", str(STAGE_ACCUM)]
        argvs = {
            "pretrain": ["--model_name_or_path", dirs["dense"]],
            "align": ["--policy_model_name_or_path", outs["pretrain"],
                      "--ref_model_name_or_path", dirs["teacher"]],
            "dpo": ["--policy_model_name_or_path", outs["align"],
                    "--ref_model_name_or_path", dirs["teacher"]],
        }
        results = {}
        for stage, config in STAGE_CONFIGS:
            argv = argvs[stage] + common + ["--data_path", data[stage],
                                            "--output_dir", outs[stage]]
            results[stage] = drive_stage(stage, os.path.join(here, config),
                                         argv, tok, dev, card)
            if stage == "pretrain":
                check_stage1_outputs(dirs["dense"], outs["pretrain"])
            if stage == "align":
                check_float_head(outs["pretrain"], outs["align"])
                moe = _moe_config(outs["align"])
                log(f"[stages] align: output config {moe}")
                every_2nd = list(range(0, _num_layers(outs["align"]), 2))
                if not (moe["moe_num_experts"] == 4 and moe["moe_top_k"] == 2
                        and moe["moe_capacity_factor"] == 1.5
                        and moe["moe_layers"] == every_2nd):
                    raise AssertionError(f"stage 2 wrote {moe}")
                shutil.rmtree(dirs["dense"])
                shutil.rmtree(outs["pretrain"])
            if stage == "dpo":
                moe = _moe_config(outs["dpo"])
                if not ("loss/moe_balance" in results["dpo"]["last"]
                        and moe == _moe_config(outs["align"])):
                    raise AssertionError("stage 3 did not train stage 2's "
                                         "MoE student")
                log("[stages] dpo: trained stage 2's MoE student (router aux "
                    "loss logged, MoE config carried to the output)")
        return dict(results, write_models_s=write_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check needs a GPU",
              file=sys.stderr)
        return 2
    # the port must be importable before anything is printed: a copy of this
    # script without the package prints no result
    from llavamod_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.load_library()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s -> "
        f"{cuda_build.build_info['path']}")
    spills = []
    for line in str(cuda_build.build_info["log"]).splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "C75", "warning")):
            log(f"[build] {line.strip()}")
        if ("spill" in line and "0 bytes spill stores, 0 bytes spill loads"
                not in line) or "C7512" in line:     # C7512: wgmma serialised
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_flash_fwd(gen, dev)
    k2 = check_flash_decode(gen, dev)
    k3, k4 = check_flash_bwd(gen, dev)

    int8_gemm = check_int8_gemm(dev)

    t0 = time.perf_counter()
    cfg, model, n_params = build_model(dev)
    torch.cuda.synchronize()
    log(f"[slice] LLaVA-MoD-2B student ({n_params / 1e9:.3f} B params, bf16, "
        f"seeded random weights) built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    served = serve_phase(cfg, model, card)
    slice_stats = logits_and_timing(cfg, model, served.pop("runner"), card)
    slice_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[slice] peak device memory {slice_stats['peak_gib']:.2f} GiB")
    served8, slice8 = int8_serving(cfg, model, slice_stats, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    trained = train_phase(card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    stages = stages_phase(card, dev)

    train_n = trained["launches"]
    serve_n = served["launches"]
    stage_n = {path: stages[stage]["launches"] for stage, path in (
        ("pretrain", "pretrain"), ("align", "align_run"), ("dpo", "dpo"))}
    stage_n["serve_int8"] = served8["launches"]
    stage_n["train_body_quant"] = trained["body_quant"]["launches"]

    def by_path(name, **first):
        return dict(first, **{p: n[name] for p, n in stage_n.items()
                              if name in n})
    regs = registers_by_kernel(str(cuda_build.build_info["log"]))
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_fwd.cu",
             replaces="llavamod_tpu/ops/flash_attention.py:75",
             launches=train_n["flash_fwd"],
             launches_by_path=by_path("flash_fwd", serve=serve_n["flash_fwd"],
                                      train=train_n["flash_fwd"]),
             registers=regs["flash_fwd"], splits=None, **k1),
        dict(name="flash_decode", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_decode.cu",
             replaces="llavamod_tpu/ops/decode_attention.py:57",
             launches=serve_n["flash_decode"],
             launches_by_path={"serve": serve_n["flash_decode"],
                               "serve_int8": served8["launches"][
                                   "flash_decode"]},
             registers=regs["flash_decode"], **k2),
        dict(name="flash_dq", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_dq.cu",
             replaces="llavamod_tpu/ops/flash_attention.py:228",
             launches=train_n["flash_dq"],
             launches_by_path=by_path("flash_dq", train=train_n["flash_dq"]),
             registers=regs["flash_dq"], splits=None, **k3),
        dict(name="flash_dkv", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_dkv.cu",
             replaces="llavamod_tpu/ops/flash_attention.py:265",
             launches=train_n["flash_dkv"],
             launches_by_path=by_path("flash_dkv",
                                      train=train_n["flash_dkv"]),
             registers=regs["flash_dkv"], splits=None, **k4),
    ]
    log(json.dumps({"serve": dict(slice_stats,
                                  requests_per_s=served["requests_per_s"]),
                    "serve_int8": dict(slice8,
                                       requests_per_s=served8["requests_per_s"]),
                    "int8_gemm": int8_gemm, "train": trained,
                    "stages": stages, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
