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
     timed in both forms; one more step of each is profiled.  Then
     [train fused], the JAX package's configuration of record for stage 2:
     Adafactor and the fused backward+update step, FUSED_ACCUM (4; the
     recipe's accumulation is 8) microbatches folded into one batch,
     gating groups of one sequence, the int8 options; one update at a
     constant lr of 1e-2 against the unfused path (make_align_step +
     Adafactor + MultiSteps(FUSED_ACCUM)) on the
     same microbatches (loss, grad_norm and the updated weights), then a
     warm-up, 2 timed updates, the share of bf16 entries one update at the
     recipe's lr leaves unchanged, and a profiled update, each launching
     K1 / K3 / K4 exactly as the chunk rules give; [moe dispatch]: one
     step each with gather, ragged and einsum dispatch and with
     remat_policy='moe', loss and grad_norm against gather, step ms, peak
     memory and the dispatch kernels' device ms.  Last, 2 steps of the
     router-only `policy_body_quant` recipe: the student body in int8, the
     routers trained through the straight-through backward, every other
     weight bitwise unchanged;
  6. stages: the trainer entry point (`train/run.py::run_stage`) through
     the paper's three stages at full width, from the repository's stage
     configs as written, chained through checkpoint directories in a
     temporary directory (removed at the end whatever happens).  The stages
     start from Hugging Face checkpoint directories, as the recipes do
     ([hf]): a seeded Qwen1.5-1.8B written as its public release lays it
     out (config.json, 2 bf16 safetensors shards and their index; stage 1
     fills the projector and the tower from its seed) and a seeded
     LLaVA-Qwen1.5-7B teacher without a tower written by the port's
     `export_hf_llava` (pytorch_model.bin); each is built by
     `build_llava`'s HF branch on the card, its llm.* and projector.*
     entries bitwise the seeded source, with the seconds to write and to
     load and the host's peak resident memory of the load.  Seeded
     336x336 PNGs and three JSON datasets in the reference formats, read
     through a stand-in tokenizer; the recipes' chain
     stage 1 (projector only, B=8, accumulation 2) -> [data] -> stage 2a
     (the port's recipes/train/dense2dense_distillation.sh as written,
     its flags read out of the file: the dense student, kd_lm against the
     bf16 teacher, the whole LLM and the projector trained, B=1,
     accumulation 2; the output config dense, the tower bitwise stage 1's,
     every LLM and projector matrix moved) -> stage 2 (from 2a's output,
     upcycled to 4 experts top-2 inside the stage, kd_lm against the
     teacher in W8A8 with an int8 head, the student head pre-quantized,
     record train set, B=1, accumulation 2) -> stage 3 (kto_pair against
     the teacher, the whole LLM trainable, one pair, accumulation 2), 4
     microbatches each.  [data] drives the trainer's loader of the
     stage-1 config (B=8, 8 worker threads, DevicePrefetcher onto the
     card) over the stage-1 data: host ms to build a batch and ms a batch
     delivered, on the C++ preprocessor and with LLAVAMOD_NO_NATIVE=1,
     beside stage 1's microbatch; no image batch of the whole run but that
     PIL pass's may take the PIL path.
     Per stage it checks that every logged metric is finite, that the
     optimizer took 2 updates, that every microbatch launched K1, K3 and K4
     as the stage's layers and remat require, and that the first
     microbatch agrees with the same step through plain attention; stage 1
     must leave every decoder and tower weight bitwise unchanged and write
     a loadable mm_projector.bin, stage 2 must shrink its teacher, write
     an MoE model and save the float student head bitwise as it came, and
     stage 3 must train it.  Stage 2 runs again with `--optimizer
     adafactor --fused_update` ([stages fused]: 2 updates of 2 folded
     microbatches on a dataset of one repeated sample, the global-gating
     warning, peak memory beside AdamW's), and a second run resumed from
     its checkpoint after update 1 must reach the same second update.
     Around stage 2, [dist]: stage 2 again from 2a's output and its
     config as written, under `python -m torch.distributed.run --standalone
     --nproc_per_node 1` (NCCL, the mesh (1,1,1,1,1), both models sharded
     by FSDP2, the gating all-gather and the expert exchange through NCCL;
     the worker is this script's `--dist-worker` entry, which calls
     `run_stage` with the stand-in tokenizer, since the card's machine has
     no tokenizer files): its microbatch ms, tokens/s and peak beside the
     single-process stage 2, K1 / K3 / K4 per microbatch, the first
     microbatch against the single-process one, the seconds to write the
     sharded checkpoint after update 1, rank 0's model.pt through
     `load_pretrained_model` against the single-process output, and a
     second torchrun resumed from that checkpoint, whose update 2 must
     repeat the first run's (one microbatch of it profiled: the NCCL
     kernels' and FSDP2's copy-in / copy-out device ms); a failed worker
     fails the smoke.  That torchrun's worker then runs [dist fused] and
     [dist lora] (`[stages fused]`'s and `[lora]`'s argv, one after the
     other in the same process and NCCL group), digests rank 0's model.pt
     and adapter files and removes them; after their single-process runs
     [dist fused] must give both updates and every model.pt entry bitwise
     (K1 / K3 / K4 an update, update ms, peak GiB and the first update's
     allocations by site beside the single process, the global-gating
     warning), and [dist lora] the first microbatch, adapter_model.bin,
     non_lora_trainables.bin and the merged model.pt bitwise (every
     adapted base weight unchanged, every `b` moved, K1 / K3 / K4 a
     microbatch, microbatch ms and peak).  Then [tp]: first a probe of which collectives gloo
     serves for CUDA tensors (2 ranks on cuda:0; a missing one fails the
     phase), then stage 2 again at `--tensor_parallel 2
     --sequence_parallel true` under one `torch.distributed.run
     --nproc_per_node 2` (the `--tp-worker` entry starts the gloo group
     itself, both ranks on cuda:0: NCCL refuses two ranks on one card):
     each rank's K1 / K3 / K4 per microbatch and the (query, KV) heads
     every attention call was handed (8 of the student's 16, 16 of the
     teacher's 32), the first microbatch against the single-process stage
     2 (LOSS_REL_TOL, GRAD_NORM_REL_TOL), every parameter that `tensor`
     leaves whole equal on the two ranks after update 1, the sharded
     checkpoint written by both ranks, rank 0's model.pt against the
     single-process output (frozen entries bitwise, trained ones by their
     updates from the upcycled start, TP_UPDATE_DISAGREE_MAX, with two
     planted faults that must exceed it), the microbatch ms, each rank's
     peak and the tensor group's collectives in a profiled microbatch
     (host ops, device copies: gloo stages CUDA tensors through the host,
     so the times are the path's floor cost, not a scaling number).
     The same worker then runs [tp generate]: the student [tp] has just
     trained generates 16 greedy tokens for 8 image prompts under its
     tensor=2 context (the cache on each rank's 8 of 16 KV heads, K1 on
     every layer in the prefill, K2 on every layer in each decode step),
     token for token the single-process generation of rank 0's model.pt;
     and [pp]: stage 2 at `--pipeline_parallel 2 --pipeline_microbatches
     2` at B = 2 (full depth: 12 student and 16 teacher layers a stage;
     gating groups of one sequence), each rank's K1 / K3 / K4 a step
     exact (40 / 12 / 12 a one-row microbatch), the first step against the
     same argv's single-process run without the pipeline (DIST_LOSS_REL_TOL,
     DIST_GRAD_NORM_REL_TOL), the parameters outside the layers equal on
     the two stages after update 1, rank 0's model.pt (the stages joined)
     held as [tp]'s, each rank's peak and the transport's host ms; gloo's
     point-to-point on CUDA tensors is probed by a torchrun of its own;
  7. eval: on stage 3's trained student, still in the temporary directory,
     the port's eval CLI (`eval/cli.py generate`) answers 20 POPE-format
     questions over the stage images in batches of 8 (the last padded),
     32 new tokens, with the router-probability dump: every prefill and
     gating forward must launch K1 on every layer, every decode step K2 on
     every layer, and no decoder attention may take the plain path (the
     expected counts are printed beside the measured ones); the first
     batch's prefill logits are held against plain attention; the same
     run with an int8 KV cache (K2's int8 mode on every step) must give
     the same first token in every row, and one with W8A8 weights and the
     int8 cache must answer every question; two --num-chunks 2 fan-out
     runs go through merge, convert --benchmark gqa and score --benchmark
     pope; then `run_llava.single_query` and the chat CLI, streamed and
     not, whose greedy replies must be equal.  Each run prints
     questions/s, the host ms of batch building, prefill ms, decode
     ms/step and peak device memory;
  8. [hf] round trip: stage 3's student written by `export_hf_llava`
     (DeepSpeed MoE keys, the embedded moe block) and its tower as an HF
     CLIP directory (held by a round trip on the card); the eval CLI with
     `--vision-path` (`load_pretrained_model(hf_dir, vision_path=...)`)
     answers the 20 questions again, every row token for token and the
     first batch's prefill logits bitwise the native bf16 run's, with K1 /
     K2 launches as expected and no plain attention; tools/import_hf, tools/consolidate and
     tools/extract_mm_projector on the HF directory must give stage 3's
     llm.* and projector.* bit for bit;
  9. [lora] (after [stages fused], from stage 2a's output): stage 2 from its
     config as written plus `--lora_enable True` (r 128, alpha 256, FFN
     adapters, per expert on the experts; the student head quantized per
     step from the live weights), its microbatch time, tokens/s and peak
     beside stage 2 without adapters, K1/K3/K4 every microbatch, the
     plain-attention first microbatch; every adapted base weight bitwise
     unchanged before the final save and every `b` moved; the upcycled base
     built again from the seed and saved, `tools.merge_lora` onto it, each
     adapted weight within one bf16 ulp (of the larger of the entry and
     the rank-r product) of the stage's merged output; the
     eval CLI with `--model-path out/adapter --model-base <base>` answers
     LORA_EVAL_QUESTIONS questions token for token as the merged directory
     does (first
     batch's prefill logits bitwise), K1/K2 on every layer;
 10. [projectors] (last): two stage-1 runs from the stage-1 config on a
     preset of Qwen1.5-1.8B's widths cut to 6 of its 24 layers (the
     smoke's time limit), one with `--s2 True --s2_scales 336,672
     --image_projector_type qformer2_64`, one with the video projector
     (`--video_tower clip-vit-l-336 --video_projector_type simple_in1_out1`
     and the three summaries; 8 seeded frames a video, 1,392 video tokens):
     2 updates each, K1/K3/K4 every microbatch, the plain-attention first
     microbatch, only projector.* / video_projector.* moved, mm_projector.bin
     read back bitwise; then one batch of 8 questions through the eval CLI
     on the Q-Former output.

Prints the kernels' JSON line before the last and, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises (exit code 1).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
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

#  * [train fused]: one fused update (FUSED_ACCUM microbatches folded,
#    gating groups of one sequence) against the unfused path
#    (make_align_step, Adafactor, MultiSteps(FUSED_ACCUM)) from the same
#    weights and microbatches.  The
#    forwards run the same kernels at the same shapes (one B=1 chunk per
#    microbatch), so the mean loss moves only by the order of the
#    microbatch sums (limit LOSS_REL_TOL); the gradients are summed in bf16
#    in another order (per layer and microbatch, against MultiSteps'
#    running mean), limit GRAD_NORM_REL_TOL.  The parameters after that
#    update, at a constant lr of 1e-2 (the recipe's 2e-5 moves almost no
#    bf16 entry), by ||p_fused - p_unfused|| / ||p_unfused - p_0|| over the
#    trainable set: each path rounds p - u to bf16, and an update of
#    ~1e-2 rms(p) is 2-3 bf16 ulps of an entry, so where the two u differ
#    by the gradients' rounding (~1e-2 relative) some 3-10% of entries
#    round one ulp apart, ~0.05-0.15 of the update's norm; an update that
#    missed one of its microbatches, or used other Adafactor blocks or
#    another lr, is off by 0.35 or more.
FUSED_PARAM_REL_TOL = 0.25
#  * [stages fused] auto-resume: the run resumed from the checkpoint after
#    update 1 against the uninterrupted run, on identical batches: the same
#    kernels on the same inputs.  Update 2's loss rel 1e-5 and grad_norm
#    rel 1e-3, and the weights after it within 5e-2 of update 2's own
#    change (||w_resumed - w_whole|| / ||w_whole - w_after_update_1||): a
#    non-deterministic reduction, if the path holds one, flips single bf16
#    roundings; a resume that lost the Adafactor statistics or the update
#    count moves the update by its whole size.
RESUME_LOSS_REL_TOL = 1e-5
RESUME_GRAD_NORM_REL_TOL = 1e-3
RESUME_PARAM_REL_TOL = 5e-2
#  * [dist]: stage 2 under a one-rank NCCL torchrun against the
#    single-process stage 2 of the same call.  At world 1 FSDP2's gathers
#    and reductions are copies and the gating gather and the expert
#    exchange move every token to itself, so the kernels see the same
#    tensors: first microbatch loss rel 1e-4 and grad_norm rel 1e-3 (and
#    the line says whether they are bitwise); the run resumed from the
#    sharded checkpoint repeats update 2 within the RESUME_* limits above.
DIST_LOSS_REL_TOL = 1e-4
DIST_GRAD_NORM_REL_TOL = 1e-3
DIST_TIMEOUT_S = 600
#  * [tp]: rank 0's model.pt against the single-process stage 2 output.
#    The frozen llm.* entries must be bitwise.  A trained entry is compared
#    by its update from the upcycled start (stage 2a's FFN copied into each
#    expert, a zero router): the recipe's lr of 2e-5 moves a bf16 entry by
#    about lr, or by a whole ulp, whatever the size of its gradient (AdamW's
#    first steps are close to lr * sign(g)), so the two runs' updates agree
#    to one bf16 ulp except where the ranks' rounding flips the sign of a
#    near-zero gradient, or a near tie in the routing moves a token.  Each
#    entry's share of moved elements that disagree by more than one ulp is
#    held under TP_UPDATE_DISAGREE_MAX; planted faults (the routers left at
#    their start, every update negated) must exceed it in every entry they
#    touch, or the check fails as one that sees nothing.
TP_UPDATE_DISAGREE_MAX = 5e-2
#  * [moe dispatch]: gather, ragged and einsum dispatch route the same
#    tokens to the same slots with the same weights, so one step from the
#    same weights differs only by the order of the expert sums (loss rel
#    1e-3, grad_norm rel 5e-2 against gather; remat_policy 'moe' against
#    'none' likewise).
DISPATCH_LOSS_REL_TOL = 1e-3
DISPATCH_GRAD_NORM_REL_TOL = 5e-2

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
# the recipe folds 8 microbatches (gradient_accumulation_steps); the smoke
# folds 4 since PR 14, for the time limit: each comparison is like for
# like (the check update against MultiSteps(FUSED_ACCUM)); the update's
# Adafactor step spreads over fewer microbatches, so ms a microbatch reads
# higher than at 8
FUSED_ACCUM = 4
FUSED_TIMED_UPDATES = 2
FUSED_CHECK_LR = 1e-2
RECIPE_LR = 2e-5
DISPATCH_MODES = ("gather", "ragged", "einsum")
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


_T0 = time.perf_counter()


def log_time(phase: str) -> None:
    """The seconds since the script started, at the end of `phase`."""
    log(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s")


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


def kernel_rows(prof):
    """[(device activity name, device ms, count)] of a finished
    torch.profiler run, summed from its raw kineto events: the rows
    `key_averages()` gives for CUDA, without the host event tree it builds
    first (about 45 s for 150,000 kernels on the H100 machine's host,
    against about 2 s for this)."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = agg.get(e.name(), (0.0, 0))
            agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(k, ms, n) for k, (ms, n) in agg.items()]


def profile_window(fn):
    """Run fn() once under torch.profiler; returns (wall ms, [(CUDA kernel
    name, device ms, count)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, kernel_rows(prof)


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
    streamed request's (B=1) carry their SDPA time and bound, the int8-cache
    serving case its time and bound alone (no library call computes it).
    Returns the B=8 bf16 case with every timed case under `by_shape`."""
    from llavamod_tpu_torch.ops.decode_attention import (
        decode_splits,
        flash_decode,
        flash_decode_reference,
    )
    from llavamod_tpu_torch.ops.tolerance import max_abs_err, tol_ratio

    s_len = PROMPT_LEN + NEW_TOKENS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [  # name, B, H, KH, D, int8, timed (against SDPA / alone)
        ("serving decode bf16", 8, 16, 16, 128, False, "library"),
        ("streamed decode bf16", 1, 16, 16, 128, False, "library"),
        ("serving decode int8", 8, 16, 16, 128, True, "alone"),
        ("gqa", 4, 14, 2, 64, False, None),
    ]
    timed = {}
    for name, b, h, kh, d, quant, timing in cases:
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
        if timing is None:
            continue
        live = int((seg != 0).sum().item())     # cache slots read
        # K and V of the live slots in the cache dtype (with their f32
        # scales in int8 mode), q, out and the segment row
        moved = (nbytes(q, out, seg) + 2 * live * kh * d * k.element_size()
                 + (2 * live * kh * 4 if quant else 0))
        timed[name] = dict(max_abs_err=err, **tk, plain_ms=plain_ms,
                           library_ms=None, library_event_ms=None,
                           splits=splits, deterministic=same_bits,
                           **bound(4 * d * h * live, moved))
        if timing == "alone":
            log(f"[kernel] flash_decode {name}: no PyTorch call computes "
                f"attention over an int8 cache with per-slot scales (no "
                f"library time); bound {timed[name]['bound_ms']:.4f} ms "
                f"({timed[name]['bound_by']}, {live} live slots of "
                f"{b * s_len}), kernel / bound "
                f"{tk['ms'] / timed[name]['bound_ms']:.2f}x")
            continue
        qt = q[:, :, None]
        mask = (seg != 0)[:, None, None, :]
        lib = timings(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask, enable_gqa=h != kh))
        timed[name].update(library_ms=lib["ms"],
                           library_event_ms=lib["event_ms"])
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


def activated_line(cfg) -> str:
    from llavamod_tpu_torch.models.llm.upcycle import activated_params

    n = activated_params(cfg.llm)
    return (f"{n:,} activated LLM parameters a token "
            f"({n / 1e9:.3f} B; the paper's \"2B activated\")")


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


def prefill_logits_vs_plain(cfg, model, batch, tag: str,
                            logits_tol: float = LOGITS_REL_TOL):
    """The batch's prefill last-position logits through the kernels (K1,
    the cache written as generation writes it) and through plain
    attention; fails unless they agree within `logits_tol` of the largest
    logit.  Returns (kernel-path logits, relative difference)."""
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.llm import decoder

    b, t = batch.input_ids.shape
    with torch.inference_mode():
        seg = batch.segment_ids
        pos = torch.clamp_min(torch.cumsum(seg, dim=1) - 1, 0)
        bp = batch._replace(positions=pos)
        cache = decoder.init_cache(cfg.llm, b, t + NEW_TOKENS,
                                   device=seg.device)
        hk = llava.forward(model, cfg, bp, cache=cache,
                           attn_impl="fresh").hidden
        hp = llava.forward(model, cfg, bp, cache=None, attn_impl="xla").hidden
        lk = llava.logits(model, cfg, hk[:, -1:])[:, 0]
        lp = llava.logits(model, cfg, hp[:, -1:])[:, 0]
        torch.cuda.synchronize()
        diff = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    ok = bool(torch.isfinite(lk).all().item()) and diff <= logits_tol * scale
    log(f"{tag} prefill last-position logits [{b}, "
        f"{lk.shape[-1]}], kernel path vs plain attention: max abs diff "
        f"{diff:.4e}, max |logit| {scale:.4e}, rel {diff / scale:.4e} "
        f"(tol {logits_tol}), greedy argmax agreement {agree:.3f}")
    if not ok:
        raise AssertionError("kernel-path prefill logits disagree with the "
                             "plain-attention forward")
    return lk, diff / scale


def logits_and_timing(cfg, model, runner, card: str, tag: str = "[slice]",
                      logits_tol: float = LOGITS_REL_TOL):
    from llavamod_tpu_torch import generation
    from llavamod_tpu_torch.generation import GenerationConfig

    pp = runner.image_preprocessor
    rng = np.random.RandomState(1)
    from PIL import Image

    imgs = [pp(Image.fromarray(rng.randint(0, 256, (400, 300, 3),
                                           dtype=np.uint8)))
            for _ in range(MAX_BATCH)]
    prompts = [runner.build_prompt(f"Question number {i}?", True)
               for i in range(MAX_BATCH)]
    batch = runner._encode_batch(prompts, imgs)
    lk, logits_rel = prefill_logits_vs_plain(cfg, model, batch, tag,
                                             logits_tol)

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
                decode_ms_per_step=step_ms, logits_rel=logits_rel,
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

    return batch_from_arrays(train_arrays(cfg, SEED), device=dev)


def train_arrays(cfg, seed: int) -> dict:
    """The host arrays of `train_batch` drawn from `seed`."""
    rng = np.random.RandomState(seed)
    t, n_img, s = TRAIN_T, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(10, 1000, size=(1, t)).astype(np.int32)
    image_mask = np.zeros((1, t), bool)
    image_mask[:, 1:1 + n_img] = True
    image_pos = np.zeros((1, t), np.int32)
    image_pos[0, 1:1 + n_img] = np.arange(n_img)
    labels = np.where(image_mask, -100, ids)
    labels[:, :t // 4] = -100
    return {"input_ids": ids, "segment_ids": np.ones((1, t), np.int32),
            "image_mask": image_mask, "image_pos": image_pos,
            "pixels": rng.randn(1, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((1, 1), bool), "labels": labels}


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
    # the loop's last pair still names the bf16 teacher
    del state, teacher, runs, fn, tch, ctx
    gc.collect()
    torch.cuda.empty_cache()
    log_time("[train] steps")
    fused = train_fused_phase(cfg, student, teacher_cfg, teacher8, head8,
                              tcfg8, card)
    log_time("[train fused]")
    dispatch = moe_dispatch_phase(cfg, student, teacher_cfg, teacher8, head8,
                                  tcfg8, batch, card)
    log_time("[moe dispatch]")
    body = body_quant_steps(cfg, student, teacher_cfg, teacher8, tcfg, batch,
                            per_step, card)
    return dict(fused=fused, dispatch=dispatch,
                step_ms=ms["bf16"], tokens_per_s=n_tok / med["bf16"] * 1e3,
                peak_gib=peaks["bf16"], trainable=n_train, launches=launches,
                first_step=first, plain_first_step=plain, rel=rel,
                profile=prof, int8=dict(
                    step_ms=ms["int8"],
                    tokens_per_s=n_tok / med["int8"] * 1e3,
                    peak_gib=peaks["int8"], teacher_gib=gib,
                    teacher_forward_ms=fwd_ms, first_step=first8,
                    rel_to_bf16=rel8, profile=prof8),
                body_quant=body)


def _sq_dist(a: dict, b: dict, dev=None) -> float:
    """Sum over the tensors of ||a - b||^2, in f32 (on `dev`, tensor by
    tensor, when given)."""
    return sum((a[n].to(dev).float() - b[n].to(dev).float()).pow(2).sum()
               .item() for n in a)


def train_fused_phase(cfg, student, teacher_cfg, teacher8, head8, tcfg8,
                      card):
    """[train fused]: the JAX package's configuration of record for stage 2
    (bench.py BENCH_CONFIG=flagship): Adafactor, the fused backward+update
    step, FUSED_ACCUM microbatches folded into the batch (B=FUSED_ACCUM,
    T=2048; the recipe folds 8), gating groups of one sequence, no remat,
    with the stage-2 config's int8
    options (the int8_head teacher, the student head in int8).  bench.py's
    student attention and embedding int8 (BENCH_STUDENT_ATTN_QUANT,
    BENCH_EMBED_QUANT) quantize outside the trainer and are left out.

    One update at a constant lr of 1e-2 is held against the unfused path
    (make_align_step, Adafactor, MultiSteps(FUSED_ACCUM)) on the same
    FUSED_ACCUM microbatches
    from the same weights; then, at the recipe's peak lr of 2e-5, a
    warm-up and 2 timed updates (peak memory over these three), one update
    whose bitwise-unchanged share of trainable entries is counted, and one
    profiled update.  Every update must launch K1 / K3 / K4 exactly as the
    auto chunk rules give: the teacher in 1-row chunks, the student forward
    in one chunk per microbatch, the backward one microbatch at a time."""
    from llavamod_tpu_torch.train.fused_steps import (
        init_fused_state,
        make_fused_align_step,
    )
    from llavamod_tpu_torch.train.loader import fold_microbatches
    from llavamod_tpu_torch.train.optim import TrainState, apply_trainable_mask
    from llavamod_tpu_torch.train.steps import (
        batch_from_arrays,
        make_align_step,
    )

    dev = student.llm.final_norm.weight.device
    cfg_f = cfg.replace(llm=cfg.llm.replace(moe_gating_group_size=TRAIN_T))
    tcfg_f = tcfg8.replace(optimizer="adafactor",
                           grad_accum_steps=FUSED_ACCUM, remat=False)
    arrays = [train_arrays(cfg, SEED + 10 + i) for i in range(FUSED_ACCUM)]
    (folded,) = list(fold_microbatches(
        iter(arrays), FUSED_ACCUM,
        rows_per_sample=cfg.max_images * cfg.num_image_tokens))
    micro = [batch_from_arrays(a, device=dev) for a in arrays]
    batch = batch_from_arrays(folded, device=dev)
    n_tok = batch.input_ids.numel()
    layers, t_layers = cfg.llm.num_layers, teacher_cfg.llm.num_layers
    per_update = {"flash_fwd": (t_layers + 2 * layers) * FUSED_ACCUM,
                  "flash_dq": layers * FUSED_ACCUM,
                  "flash_dkv": layers * FUSED_ACCUM}
    check = tcfg_f.replace(lr_schedule="constant", warmup_ratio=0.0,
                           learning_rate=FUSED_CHECK_LR)
    recipe = check.replace(learning_rate=RECIPE_LR)

    def run_update(step, state, label):
        before = _launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, teacher8, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        vals = {k: v.item() for k, v in m.items()}
        got = {k: n - before[k] for k, n in _launch_counts().items()}
        log(f"[train fused] {label}: {dt * 1e3:.1f} ms loss "
            f"{vals['loss']:.5f} grad_norm {vals['grad_norm']:.5f} "
            f"launches {got}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{label}: non-finite metrics {vals}")
        if got != per_update:
            raise AssertionError(f"{label} launched {got}, expected "
                                 f"{per_update} per update")
        return state, vals, dt

    with swapped_head(student.llm, head8):
        mask = apply_trainable_mask(student, tcfg_f)
        params = {n: p for n, p in student.named_parameters() if mask[n]}
        n_train = sum(p.numel() for p in params.values())
        p0 = {n: p.detach().clone() for n, p in params.items()}

        def restore():
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(p0[n])

        # the unfused reference: the microbatches through MultiSteps; the
        # inner optimizer's return is the norm of the mean gradient
        t0 = time.perf_counter()
        state = TrainState.create(student, check)
        norms, inner_update = [], state.opt.inner.update
        state.opt.inner.update = lambda g: norms.append(inner_update(g))
        step = make_align_step(cfg_f, teacher_cfg, check)
        losses = []
        for b in micro:
            state, m = step(state, teacher8, b)
            losses.append(m["loss"].item())
        ref = {"loss": statistics.fmean(losses), "grad_norm": norms[0].item()}
        p_ref = {n: p.detach().clone() for n, p in params.items()}
        ref_s = time.perf_counter() - t0
        restore()
        del state, step, norms
        gc.collect()
        torch.cuda.empty_cache()

        _reset_launch_counts()
        fstep = make_fused_align_step(cfg_f, teacher_cfg, check)
        state, got, _ = run_update(fstep, init_fused_state(student, cfg_f,
                                                           check),
                                   "check update, lr 1e-2")
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k])
               for k in ("loss", "grad_norm")}
        rel["params"] = (math.sqrt(_sq_dist(params, p_ref))
                         / math.sqrt(_sq_dist(p_ref, p0)))
        restore()
        del state, p_ref, p0
        log(f"[train fused] one fused update vs the unfused path "
            f"(make_align_step + Adafactor + MultiSteps({FUSED_ACCUM}), "
            f"{ref_s:.1f} s), constant lr {FUSED_CHECK_LR}: loss "
            f"{got['loss']:.6f} vs mean {ref['loss']:.6f} (rel "
            f"{rel['loss']:.3e}, tol {LOSS_REL_TOL}), grad_norm "
            f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (rel "
            f"{rel['grad_norm']:.3e}, tol {GRAD_NORM_REL_TOL}), "
            f"||p_fused - p_unfused|| / ||p_unfused - p_0|| "
            f"{rel['params']:.4f} (tol {FUSED_PARAM_REL_TOL})")
        if not (rel["loss"] <= LOSS_REL_TOL
                and rel["grad_norm"] <= GRAD_NORM_REL_TOL
                and rel["params"] <= FUSED_PARAM_REL_TOL):
            raise AssertionError(f"the fused update disagrees with the "
                                 f"unfused path: {rel}")

        # the recipe's lr: warm-up, timed updates, the unchanged share, and
        # a profiled update
        fstep = make_fused_align_step(cfg_f, teacher_cfg, recipe)
        state = init_fused_state(student, cfg_f, recipe)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        times = []
        for i in range(1 + FUSED_TIMED_UPDATES):
            state, _, dt = run_update(fstep, state,
                                      "warm-up update" if i == 0
                                      else f"timed update {i}")
            if i:
                times.append(dt * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        before = {n: p.detach().clone() for n, p in params.items()}
        state, _, _ = run_update(fstep, state, "update at lr 2e-5")
        same = sum((before[n] == p).sum().item() for n, p in params.items())
        del before
        med = statistics.median(times)
        prof_state, prof = profile_step(fstep, state, teacher8, batch, med,
                                        "[train fused] profiled update")
        launches = _launch_counts()
        n_updates = 3 + FUSED_TIMED_UPDATES
        if launches != {k: v * n_updates for k, v in per_update.items()}:
            raise AssertionError(f"[train fused] launched {launches} over "
                                 f"{n_updates} updates")
        del state, prof_state
    gc.collect()
    torch.cuda.empty_cache()
    share = same / n_train
    log(f"[train fused] make_fused_align_step, {FUSED_ACCUM} microbatches "
        f"of B=1 T={TRAIN_T} folded, groups of {TRAIN_T}, int8_head teacher "
        f"+ int8 student head, {n_train / 1e9:.3f} B trainable: update ms "
        f"{' / '.join(f'{t:.1f}' for t in times)} (median {med:.1f}, "
        f"{med / FUSED_ACCUM:.1f} ms a microbatch), {n_tok / med * 1e3:.1f} "
        f"tokens/s, peak device memory {peak:.2f} GiB; launches per update "
        f"{per_update}; on {card}")
    log(f"[train fused] one update at the recipe's lr {RECIPE_LR} left "
        f"{same} of {n_train} trainable bf16 entries bitwise unchanged "
        f"({share:.6f}); on {card}")
    return dict(update_ms=times, median_ms=med,
                microbatch_ms=med / FUSED_ACCUM,
                tokens_per_s=n_tok / med * 1e3, peak_gib=peak,
                per_update=per_update, launches=launches, check=got,
                reference=ref, rel=rel, unchanged_share=share,
                profile=prof)


# device kernels of the MoE dispatch, by name fragment
DISPATCH_OPS = {
    "index backward": ("indexing_backward_kernel",),
    "gather / index": ("index_elementwise_kernel", "vectorized_gather",
                       "gather_kernel"),
    "scatter / index_put": ("scatter", "index_put"),
    "cat": ("CatArrayBatchedCopy",),
    "cumsum": ("scan",),
}


def dispatch_op_ms(rows) -> dict:
    return {k: sum(ms for n, ms, _ in rows if any(f in n for f in frags))
            for k, frags in DISPATCH_OPS.items()}


def moe_dispatch_phase(cfg, student, teacher_cfg, teacher8, head8, tcfg8,
                       batch, card):
    """[moe dispatch]: one align step (Adafactor, the int8 options, B=1,
    T=2048, gating groups of one sequence) from the same weights with
    moe_dispatch gather, ragged and einsum, then gather with
    remat_policy='moe' (full remat off).  Every step starts from a fresh
    Adafactor state, whose first update has lr 0 under the recipe's
    warmup: the weights stay as they are (checked).  Each mode: a warm-up
    step, a timed step (peak memory) and a profiled one (device ms of the
    dispatch kernels).  Measurements only: no speed claim."""
    from llavamod_tpu_torch.train.optim import TrainState, apply_trainable_mask
    from llavamod_tpu_torch.train.steps import make_align_step

    tcfg_d = tcfg8.replace(optimizer="adafactor", remat=False)
    modes = [(m, dict(moe_dispatch=m)) for m in DISPATCH_MODES] + [
        ("gather, remat_policy moe", dict(moe_dispatch="gather",
                                          remat_policy="moe"))]
    layers = cfg.llm.num_layers
    per_step = {"flash_fwd": layers + teacher_cfg.llm.num_layers,
                "flash_dq": layers, "flash_dkv": layers}
    out = {}
    with swapped_head(student.llm, head8):
        mask = apply_trainable_mask(student, tcfg_d)
        params = [p for n, p in student.named_parameters() if mask[n]]
        fingerprint = [p.float().sum().item() for p in params]
        _reset_launch_counts()
        for name, kw in modes:
            cfg_m = cfg.replace(llm=cfg.llm.replace(
                moe_gating_group_size=TRAIN_T, **kw))
            step = make_align_step(cfg_m, teacher_cfg, tcfg_d)

            def one():
                _, m = step(TrainState.create(student, tcfg_d), teacher8,
                            batch)
                return {k: v.item() for k, v in m.items()}

            before = _launch_counts()
            first = one()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            wall, rows = profile_window(one)
            got = {k: n - before[k] for k, n in _launch_counts().items()}
            prof = summarize_profile(f"[moe dispatch] {name} profiled step",
                                     wall, rows, ms)
            ops = dispatch_op_ms(rows)
            out[name] = dict(first=first, step_ms=ms, peak_gib=peak,
                             dispatch_ops_ms=ops, profile=prof,
                             launches=got)
            log(f"[moe dispatch] {name}: step {ms:.1f} ms, peak "
                f"{peak:.2f} GiB, loss {first['loss']:.6f} grad_norm "
                f"{first['grad_norm']:.6f}; device ms of the dispatch "
                f"kernels: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         ops.items()) + f"; launches {got} "
                f"over 3 steps; on {card}")
            if not all(np.isfinite(v) for v in first.values()):
                raise AssertionError(f"{name}: non-finite metrics {first}")
            if got != {k: 3 * v for k, v in per_step.items()}:
                raise AssertionError(f"{name} launched {got} over 3 steps, "
                                     f"expected {per_step} a step")
        launches = _launch_counts()
        moved = [i for i, p in enumerate(params)
                 if p.float().sum().item() != fingerprint[i]]
    if moved:
        raise AssertionError(f"[moe dispatch] {len(moved)} trainable tensors "
                             f"moved: the steps did not start from the same "
                             f"weights")
    base = out["gather"]["first"]
    for name in out:
        rel = {k: abs(out[name]["first"][k] - base[k]) / abs(base[k])
               for k in ("loss", "grad_norm")}
        out[name]["rel_to_gather"] = rel
        log(f"[moe dispatch] {name} vs gather: loss rel {rel['loss']:.3e} "
            f"(tol {DISPATCH_LOSS_REL_TOL}), grad_norm rel "
            f"{rel['grad_norm']:.3e} (tol {DISPATCH_GRAD_NORM_REL_TOL})")
        if not (rel["loss"] <= DISPATCH_LOSS_REL_TOL
                and rel["grad_norm"] <= DISPATCH_GRAD_NORM_REL_TOL):
            raise AssertionError(f"{name} disagrees with gather dispatch: "
                                 f"{rel}")
    return dict(modes=out, launches=launches)


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
    exactly.  `decode` maps the ids of printable ASCII back to their
    characters and writes any other id as <id>."""
    pad_token_id = 0
    bos_token_id = None
    eos_token_id = None
    _chars = {10 + (c * 7919) % (QWEN_REGULAR_IDS - 10): chr(c)
              for c in [10] + list(range(32, 127))}

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[
            10 + (ord(c) * 7919) % (QWEN_REGULAR_IDS - 10) for c in text])

    def decode(self, ids, skip_special_tokens=True):
        return "".join(self._chars.get(int(i), f"<{int(i)}>") for i in ids)


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
        if kind == "align":
            # every batch alike, for the fused run's resume check
            paths["align_same"] = os.path.join(root, "align_same.json")
            with open(paths["align_same"], "w") as f:
                json.dump([dict(records[0], id=i) for i in range(n)], f)
    log("[stages] data: " + ", ".join(
        f"{k} {len(v)} sequences of {min(v)}-{max(v)} real tokens"
        for k, v in lengths.items()) + f" ({STAGE_IMAGES} seeded PNGs)")
    return dict(paths, images=img_dir)


def _param_count(cfg, vision: bool = True) -> int:
    from llavamod_tpu_torch.models import llava

    model = llava.init(cfg, None, device="meta", vision=vision)
    return sum(p.numel() for p in model.parameters())


def write_safetensors(path: str, state: dict) -> int:
    """Scaffolding, not a port feature: one .safetensors file in the
    documented layout (8-byte little-endian header length, the JSON header
    of dtype / shape / data_offsets padded to 8 bytes, the raw bytes).
    Returns the bytes written."""
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, offset, cpu = {}, 0, {}
    for k, v in state.items():
        cpu[k] = v.detach().to("cpu").contiguous()
        n = cpu[k].numel() * cpu[k].element_size()
        header[k] = {"dtype": names[cpu[k].dtype],
                     "shape": list(cpu[k].shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for k, v in cpu.items():
            f.write(memoryview(v.view(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def write_hf_llm(out_dir: str, llm, state: dict, shards: int = 2) -> int:
    """A text-only LLM directory as the public Qwen/Qwen1.5-1.8B release
    lays it out: config.json (model_type qwen2) and the weights in
    `shards` bf16 safetensors files of about equal size with
    model.safetensors.index.json.  Returns the bytes of the weights."""
    from llavamod_tpu_torch.interop.hf import decoder_params_to_hf

    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
            "vocab_size": llm.vocab_size, "hidden_size": llm.hidden_size,
            "intermediate_size": llm.intermediate_size,
            "num_hidden_layers": llm.num_layers,
            "num_attention_heads": llm.num_heads,
            "num_key_value_heads": llm.num_kv_heads,
            "max_position_embeddings": llm.max_position_embeddings,
            "rope_theta": llm.rope_theta, "rms_norm_eps": llm.rms_norm_eps,
            "tie_word_embeddings": llm.tie_word_embeddings,
            "hidden_act": "silu", "torch_dtype": "bfloat16",
            "use_sliding_window": False,
            "sliding_window": llm.max_position_embeddings}, f, indent=2)
    hf_state = decoder_params_to_hf(state, llm)
    total = sum(v.numel() * v.element_size() for v in hf_state.values())
    parts, size = [[]], 0
    for k, v in hf_state.items():
        if size >= total * len(parts) / shards and len(parts) < shards:
            parts.append([])
        parts[-1].append(k)
        size += v.numel() * v.element_size()
    weight_map, written = {}, 0
    for i, keys in enumerate(parts):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        written += write_safetensors(os.path.join(out_dir, name),
                                     {k: hf_state[k] for k in keys})
        weight_map.update({k: name for k in keys})
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return written


def vision_params_to_hf(state: dict, cfg) -> dict:
    """Scaffolding: the inverse of interop/hf.py `vision_params_from_hf`, an
    HF CLIPVisionModel state dict ('vision_model.*' keys, [out, in] weights,
    the [D, C, p, p] patch convolution without a bias, as HF CLIP has
    none; the tower's patch bias must be zero)."""
    p = "vision_model."
    d = cfg.hidden_size
    if "patch_embed.bias" in state and bool(state["patch_embed.bias"].any()):
        raise AssertionError("an HF CLIP tower has no patch bias")
    out = {p + "embeddings.patch_embedding.weight":
           state["patch_embed.kernel"].t().reshape(
               d, 3, cfg.patch_size, cfg.patch_size).contiguous(),
           p + "embeddings.position_embedding.weight": state["pos_embed"],
           p + "embeddings.class_embedding": state["class_token"]}
    for ours, hf_name in (("pre_ln", "pre_layrnorm"),
                          ("post_ln", "post_layernorm")):
        for leaf in ("weight", "bias"):
            out[f"{p}{hf_name}.{leaf}"] = state[f"{ours}.{leaf}"]
    for i in range(cfg.num_layers):
        q, h = f"layers.{i}.", f"{p}encoder.layers.{i}."
        for ours, hf_name in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            for leaf in ("weight", "bias"):
                out[f"{h}{hf_name}.{leaf}"] = state[f"{q}{ours}.{leaf}"]
        for ours, hf_name in (("attn.q", "self_attn.q_proj"),
                              ("attn.k", "self_attn.k_proj"),
                              ("attn.v", "self_attn.v_proj"),
                              ("attn.o", "self_attn.out_proj"),
                              ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            out[f"{h}{hf_name}.weight"] = state[f"{q}{ours}.kernel"].t() \
                .contiguous()
            out[f"{h}{hf_name}.bias"] = state[f"{q}{ours}.bias"]
    return out


class HostPeak:
    """The host's peak resident memory over a block: VmRSS sampled every
    20 ms (a process may not be allowed to reset its kernel high-water
    mark through /proc/self/clear_refs), or `getrusage` ru_maxrss where the
    block set a new peak of the process (then it is the block's peak), and
    the VmRSS before the block."""

    @staticmethod
    def _rss_gib() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 2**30
        raise RuntimeError("no VmRSS in /proc/self/status")

    @staticmethod
    def _maxrss_gib() -> float:
        import resource

        return resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 2**30

    def __enter__(self):
        self.before_gib = self._rss_gib()
        self.maxrss_before = self._maxrss_gib()
        self.samples, self.stop = [self.before_gib], threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.stop.wait(0.02):
            self.samples.append(self._rss_gib())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)
        self.samples.append(self._rss_gib())
        self.rusage_gib = self._maxrss_gib()
        self.gib = max(self.samples + ([self.rusage_gib] if self.rusage_gib
                                       > self.maxrss_before else []))
        return False


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def write_stage_models(root: str, dev) -> dict:
    """The stages' starting models as Hugging Face checkpoint directories,
    from seeded bf16 weights, as the recipes start from them: the
    text-only Qwen1.5-1.8B LLM laid out as its public release (2
    safetensors shards with an index; stage 1 fills the projector and the
    tower from its seed, exactly what the reference's stage 1 starts from)
    and the HF LLaVA-Qwen1.5-7B teacher written by the port's
    `export_hf_llava` (pytorch_model.bin, no tower).  Each directory is then
    built by `build_llava`'s HF branch on the card, and its llm.* and
    projector.* entries must equal the seeded source bit for bit.  Fails,
    with the numbers, when the disk cannot hold them and the stages'
    outputs."""
    from llavamod_tpu_torch.interop.hf import export_hf_llava
    from llavamod_tpu_torch.models import llava
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm import decoder
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
    # 2, or (the dense model gone) stage 1's output, the teacher, stage 2's
    # output and the fused stage 2's checkpoint and final model, or ([lora],
    # stage 1's output gone) the teacher, stage 2's output, the LoRA run's,
    # its base and the merged model; the HF round trip after the eval holds
    # 3 MoE students and a tower at most
    need = max(gb["dense"] * 2 + gb["teacher"] + gb["moe"],
               gb["dense"] + gb["teacher"] + gb["moe"] * 3,
               gb["teacher"] + gb["moe"] * 4) + 1.0
    free = shutil.disk_usage(root).free / 1e9
    log(f"[stages] checkpoints in {root}: dense {gb['dense']:.2f} GB, teacher "
        f"{gb['teacher']:.2f} GB, MoE student {gb['moe']:.2f} GB (bf16); at "
        f"most {need:.1f} GB on disk at once, {free:.1f} GB free")
    if free < need:
        raise AssertionError(f"the stages need {need:.1f} GB of disk in "
                             f"{root}, {free:.1f} GB are free")
    dirs, stats = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    with torch.no_grad():
        llm = decoder.init(dense_cfg.llm, gen, device=dev,
                           dtype=torch.bfloat16)
    dirs["dense"] = os.path.join(root, "Qwen1.5-1.8B")
    source = {"llm." + k: v for k, v in llm.state_dict().items()}
    t0 = time.perf_counter()
    write_hf_llm(dirs["dense"], dense_cfg.llm, llm.state_dict())
    stats["dense"] = dict(write_s=time.perf_counter() - t0,
                          bytes=dir_bytes(dirs["dense"]))
    log(f"[hf] dense: wrote {stats['dense']['bytes'] / 1e9:.3f} GB (2 bf16 "
        f"safetensors shards) in {stats['dense']['write_s']:.1f} s")
    del llm
    stats["dense"].update(check_hf_build("dense", dirs["dense"], source,
                                         "pretrain", dev))
    del source
    with torch.no_grad():
        model = llava.init(teacher_cfg, gen, device=dev, dtype=torch.bfloat16,
                           vision=False)
    dirs["teacher"] = os.path.join(root, "llava-qwen1.5-7b")
    t0 = time.perf_counter()
    export_hf_llava(dirs["teacher"], teacher_cfg, model.state_dict())
    stats["teacher"] = dict(write_s=time.perf_counter() - t0,
                            bytes=dir_bytes(dirs["teacher"]))
    log(f"[hf] teacher: wrote {stats['teacher']['bytes'] / 1e9:.3f} GB "
        f"(pytorch_model.bin) in {stats['teacher']['write_s']:.1f} s")
    source = model.state_dict()
    stats["teacher"].update(check_hf_build("teacher", dirs["teacher"], source,
                                           "align", dev))
    del model, source
    gc.collect()
    torch.cuda.empty_cache()
    return dirs, stats


def stage_seed(stage: str) -> tuple:
    """(margs, the seed `build_stage_models` gives the stage's policy and its
    teacher) from the stage's config as written."""
    config = dict(STAGE_CONFIGS)[stage]
    margs, _, targs, _ = parse_stage(stage, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), config), [])
    return margs, targs.seed, targs.seed + 7


def check_hf_build(name: str, path: str, source: dict, stage: str, dev
                   ) -> dict:
    """`build_llava`'s HF branch on `path` onto the card, as `stage` builds
    it (a policy with the stage's seed, a teacher with the teacher's):
    seconds, the host's peak resident memory, and every llm.* and
    projector.* entry of `source` bitwise in the built model."""
    from llavamod_tpu_torch.train.run import build_llava

    margs, seed, teacher_seed = stage_seed(stage)
    torch.cuda.synchronize()
    with HostPeak() as peak:
        t0 = time.perf_counter()
        cfg, model = build_llava(path, margs, seed=teacher_seed
                                 if name == "teacher" else seed, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    built = model.state_dict()
    keys = [k for k in source if k.split(".")[0] in ("llm", "projector")]
    equal = sum(bool(torch.equal(built[k], source[k].to(dev))) for k in keys)
    file_gib = dir_bytes(path) / 2**30
    rise = peak.gib - peak.before_gib
    log(f"[hf] {name}: build_llava from {os.path.basename(path)} onto the "
        f"card in {load_s:.2f} s, {cfg.llm.name} {cfg.llm.num_layers} layers "
        f"{built['llm.embed.embedding'].dtype}; host peak RSS {peak.gib:.2f} "
        f"GiB ({peak.gib / file_gib:.2f}x the "
        f"{file_gib:.2f} GiB of files), {peak.before_gib:.2f} GiB before the "
        f"load, so the load "
        f"added {rise:.2f} GiB ({rise / file_gib:.2f}x); getrusage ru_maxrss "
        f"{peak.rusage_gib:.2f} GiB; {equal} of {len(keys)} llm.* / "
        f"projector.* entries bitwise the seeded source")
    if equal != len(keys) or not keys or set(keys) - set(built):
        raise AssertionError(f"{name}: the HF build differs from its source")
    del model, built
    gc.collect()
    torch.cuda.empty_cache()
    return dict(load_s=load_s, peak_rss_gib=peak.gib,
                rss_before_gib=peak.before_gib,
                rusage_maxrss_gib=peak.rusage_gib, entries_equal=equal)


@contextlib.contextmanager
def counted_steps(records: list, profile_call=None, memory_call=None):
    """Within the block, the step functions that `run_stage` makes record,
    for each microbatch, its K1/K3/K4 launches, its time (the card
    synchronised before and after) and its peak device memory (the
    stage's whole-run peak may instead be set while the models load);
    microbatch number `profile_call` (from 0) runs under torch.profiler,
    its `dist_profile` in its record; microbatch number `memory_call`
    records the allocator's history, its `memory_breakdown` in its
    record."""
    from llavamod_tpu_torch.train import fused_steps, steps

    makers = [(steps, n) for n in ("make_pretrain_step", "make_align_step",
                                   "make_dpo_step")]
    makers.append((fused_steps, "make_fused_align_step"))
    originals = {(mod, n): getattr(mod, n) for mod, n in makers}

    def wrap(make):
        def maker(*a, **k):
            step = make(*a, **k)

            def counted(*sa, **sk):
                before = _launch_counts()
                torch.cuda.synchronize()
                prior = torch.cuda.max_memory_allocated() / 2**30
                start = torch.cuda.memory_allocated() / 2**30
                torch.cuda.reset_peak_memory_stats()
                prof = None
                if profile_call is not None and len(records) == profile_call:
                    from torch.profiler import ProfilerActivity, profile

                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                history = (memory_call is not None
                           and len(records) == memory_call)
                if history:
                    torch.cuda.memory._record_memory_history(
                        context="alloc", stacks="python",
                        max_entries=2_000_000)
                t0 = time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                if history:
                    snapshot = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                rec = dict(
                    ms=(time.perf_counter() - t0) * 1e3, prior_peak_gib=prior,
                    start_gib=start,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches={k: n - before[k]
                              for k, n in _launch_counts().items()})
                if prof is not None:
                    prof.__exit__(None, None, None)
                    rec["profile"] = dist_profile(prof, rec["ms"])
                if history:
                    rec["memory"] = memory_breakdown(snapshot)
                records.append(rec)
                return out
            return counted
        return maker

    for (mod, n), make in originals.items():
        setattr(mod, n, wrap(make))
    try:
        yield records
    finally:
        for (mod, n), make in originals.items():
            setattr(mod, n, make)


def _memory_site(frames) -> str:
    """Where an allocation was made: the innermost FSDP2 frame, else the
    innermost frame of the port, else the innermost Python frame; none at
    all (the autograd engine's own work in backward) is its own site."""
    def pick(part):
        return next((f for f in frames if part in f["filename"]), None)
    f = pick("torch/distributed/fsdp")
    if f is not None:
        return f"FSDP2 {f['name']}"
    f = pick("llavamod_tpu_torch")
    if f is not None:
        rel = f["filename"].split("llavamod_tpu_torch/")[-1]
        return f"{rel}:{f['name']}"
    if frames:
        return f"{os.path.basename(frames[0]['filename'])}:{frames[0]['name']}"
    return "autograd engine (no Python frame)"


def memory_breakdown(snapshot: dict, top: int = 8) -> dict:
    """The allocations a step made, replayed from the allocator's history
    on this device: the most bytes they held at once (the step's own
    transient; what it started with is not in the history) and, at that
    moment, the bytes by the site that allocated them."""
    dev = torch.cuda.current_device()
    live, by_site, total, peak, at_peak = {}, {}, 0, 0, {}
    for ev in snapshot["device_traces"][dev]:
        if ev["action"] == "alloc":
            site = _memory_site(ev.get("frames", []))
            live[ev["addr"]] = (ev["size"], site)
            by_site[site] = by_site.get(site, 0) + ev["size"]
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(by_site)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            size, site = live.pop(ev["addr"])
            by_site[site] -= size
            total -= size
    rows = sorted(at_peak.items(), key=lambda kv: -kv[1])[:top]
    return dict(peak_gib=peak / 2**30, sites=[dict(site=k, gib=v / 2**30)
                                              for k, v in rows])


def parse_stage(stage: str, config, argv: list):
    """The stage's dataclasses from the repository's config file (None: a
    recipe's command line alone), with the command line `argv` on top."""
    from llavamod_tpu_torch.train import args

    classes = [args.ModelArgs, args.DataArgs, args.TrainArgs]
    if stage == "align":
        classes.append(args.AlignArgs)
    if stage == "dpo":
        classes.append(args.DPOArgs)
    parsed = args.parse_into_dataclasses(
        classes, (["--config", config] if config else []) + argv)
    margs, dargs, targs = parsed[:3]
    extra = parsed[3] if len(parsed) > 3 else None
    return margs, dargs, targs, extra


def plain_first_microbatch(stage, margs, dargs, targs, extra, tok, dev):
    """The stage's first microbatch through plain attention: the step that
    `run_stage` makes, on models loaded from the same directories and the
    loader's first batch, from a fresh state (with accumulation, the first
    microbatch updates nothing).  With --fused_update: the first update,
    on the loader's first `accum` batches folded."""
    from llavamod_tpu_torch.train import fused_steps, run, steps
    from llavamod_tpu_torch.train.args import train_config_from_args
    from llavamod_tpu_torch.train.loader import (
        fold_microbatches,
        infinite_batches,
    )
    from llavamod_tpu_torch.train.optim import TrainState

    salign = extra if stage == "align" else None
    sdpo = extra if stage == "dpo" else None
    cfg, model, teacher_cfg, teacher = run.build_stage_models(
        stage, margs, targs, salign, sdpo, dev)
    batches = infinite_batches(run.build_data_module(stage, margs, dargs,
                                                     targs, tok, cfg))
    if targs.fused_update:
        batches = fold_microbatches(
            batches, targs.gradient_accumulation_steps,
            rows_per_sample=cfg.max_images * cfg.num_image_tokens
            + cfg.num_video_tokens)
    arrays = next(batches)
    batches.close()
    mods = run.translate_train_modules(margs.train_modules)
    tcfg = train_config_from_args(
        stage, targs, targs.max_steps,
        dataclasses.replace(margs, train_modules=mods), salign,
        sdpo).replace(attn_impl="xla")
    if teacher is not None and steps._can_share_tower(tcfg, cfg, teacher_cfg):
        del teacher.vision
    lora, lcfg = run.maybe_add_lora(model, margs, targs.seed)
    run.quantize_stage_models(tcfg, extra, model, teacher, lcfg)
    state = (None if targs.fused_update
             else TrainState.create(model, tcfg, lcfg, lora))
    if targs.fused_update:
        _, m = fused_steps.make_fused_align_step(cfg, teacher_cfg, tcfg)(
            fused_steps.init_fused_state(model, cfg, tcfg), teacher,
            steps.batch_from_arrays(arrays, device=dev))
    elif stage == "align":
        _, m = steps.make_align_step(cfg, teacher_cfg, tcfg, lcfg)(
            state, teacher, steps.batch_from_arrays(arrays, device=dev))
    elif stage == "dpo":
        _, m = steps.make_dpo_step(cfg, teacher_cfg, tcfg, lcfg)(
            state, teacher, arrays)
    else:
        _, m = steps.make_pretrain_step(cfg, tcfg, lcfg)(
            state, steps.batch_from_arrays(arrays, device=dev))
    out = {k: v.item() for k, v in m.items()}
    del model, teacher, m, state, lora
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _read_json_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _num_layers(model_dir: str) -> int:
    from llavamod_tpu_torch.models.builder import CONFIG_NAME
    from llavamod_tpu_torch.models.llm.config import llm_configs

    if not os.path.isdir(model_dir):            # a registered preset
        return llm_configs.get(model_dir).num_layers
    if not os.path.exists(os.path.join(model_dir, CONFIG_NAME)):
        with open(os.path.join(model_dir, "config.json")) as f:
            return json.load(f)["num_hidden_layers"]
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

    def recording(tcfg, stage_args, model, teacher, lora_cfg=None):
        before = module_gib(teacher.llm) if teacher is not None else 0.0
        stash = original(tcfg, stage_args, model, teacher, lora_cfg)
        record.update(
            lora=lora_cfg is not None,
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


def drive_stage(stage, config, argv, tok, dev, card, tag=None,
                memory_call=None):
    """One stage through `run_stage` (counts set to 0 just before, read just
    after), with the plain-attention first microbatch beside it; returns
    the stage's numbers after checking them.  With --fused_update a step is
    one update over `accum` folded microbatches: MoE with global gating
    (the stage configs set no gating groups) runs the student forward and
    backward folded, the dense teacher in 1-row chunks."""
    from llavamod_tpu_torch.train.run import run_stage

    margs, dargs, targs, extra = parse_stage(stage, config, argv)
    tag = tag or stage
    policy = (extra.policy_model_name_or_path if extra is not None
              else margs.model_name_or_path)
    layers = _num_layers(policy)
    teacher_layers = (_num_layers(extra.ref_model_name_or_path)
                      if extra is not None else 0)
    accum = targs.gradient_accumulation_steps
    fused = targs.fused_update
    per_mb = {"flash_fwd": layers * (2 if targs.remat else 1) + teacher_layers,
              "flash_dq": layers, "flash_dkv": layers}
    if fused:
        per_mb["flash_fwd"] = 2 * layers + teacher_layers * (
            targs.per_device_train_batch_size * accum)
    n_steps = targs.max_steps // accum if fused else targs.max_steps

    t0 = time.perf_counter()
    plain = plain_first_microbatch(stage, margs, dargs, targs, extra, tok, dev)
    plain_s = time.perf_counter() - t0

    kw = {"align": dict(salign=extra), "dpo": dict(sdpo=extra)}.get(stage, {})
    records, quant = [], {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps(records, memory_call=memory_call), \
            recorded_quantization(quant):
        _reset_launch_counts()
        last = run_stage(stage, margs, dargs, targs, tokenizer=tok,
                         device=dev, **kw)
        launches = _launch_counts()
    wall_s = time.perf_counter() - t0
    # the whole run's peak: the steps reset the counter (counted_steps)
    peak_gib = max([torch.cuda.max_memory_allocated() / 2**30]
                   + [max(r["prior_peak_gib"], r["peak_gib"])
                      for r in records])
    gc.collect()
    torch.cuda.empty_cache()

    out = targs.output_dir
    lines = _read_json_lines(os.path.join(out, "metrics.jsonl"))
    with open(os.path.join(out, "run_info.json")) as f:
        info = json.load(f)
    first = {k: v for k, v in lines[0].items()
             if k not in ("step", "sec_per_step")}
    finite = all(np.isfinite(v) for ln in lines for v in ln.values())
    updates = targs.max_steps // accum
    rel_keys = ["loss"] + (["logps/chosen", "logps/rejected"]
                           if stage == "dpo" else [])
    rel = {k: abs(first[k] - plain[k]) / abs(plain[k]) for k in rel_keys}
    rel["grad_norm"] = (abs(first["grad_norm"] - plain["grad_norm"])
                        / abs(plain["grad_norm"]))
    ms = [r["ms"] for r in records]
    med = statistics.median(ms[1:])
    step_peak = max(r["peak_gib"] for r in records)
    rows = targs.per_device_train_batch_size * (2 if stage == "dpo" else 1)
    rows *= accum if fused else 1
    tokens = rows * targs.model_max_length
    unit = "update" if fused else "microbatch"
    log(f"[stages] {tag}: {len(lines)} logged {unit}s, all finite: "
        f"{finite}; optimizer updates {info['optimizer_updates']} (need "
        f"{updates}); launches per {unit} "
        f"{[r['launches'] for r in records]} (need {per_mb} each)")
    log(f"[stages] {tag}: first {unit}, kernel path vs plain "
        f"attention: " + ", ".join(
            f"{k} {first[k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.3e})"
            for k in rel) + f"; tol loss/logps {LOSS_REL_TOL}, grad_norm "
        f"{GRAD_NORM_REL_TOL}")
    log(f"[stages] {tag}: {unit} ms {' / '.join(f'{t:.1f}' for t in ms)}"
        f" (median after the first {med:.1f}"
        + (f", {med / accum:.1f} a microbatch" if fused else "")
        + f"), {tokens / med * 1e3:.1f} "
        f"tokens/s ({rows} x {targs.model_max_length} padded), peak device "
        f"memory {peak_gib:.2f} GiB (of the steps {step_peak:.2f}); "
        f"checkpoints: load and build "
        f"{info['build_and_load_s']:.1f} s, save {info['save_s']:.1f} s; "
        f"run_stage {wall_s:.1f} s, plain reference {plain_s:.1f} s; on "
        f"{card}")
    if not (finite and len(lines) == n_steps
            and info["optimizer_updates"] == updates
            and info["microbatches"] == targs.max_steps):
        raise AssertionError(f"{tag}: metrics {lines} run {info}")
    if len(records) != n_steps or any(r["launches"] != per_mb
                                      for r in records):
        raise AssertionError(f"{tag}: launches {records}, need {per_mb}")
    if not (all(rel[k] <= LOSS_REL_TOL for k in rel_keys)
            and rel["grad_norm"] <= GRAD_NORM_REL_TOL):
        raise AssertionError(f"{tag}: the kernel path disagrees with plain "
                             f"attention: {rel}")
    if quant.get("ref_quant"):
        # with LoRA the student head is quantized per step, not before
        log(f"[stages] {tag}: --ref_quant {quant['ref_quant']} from the "
            f"config: teacher LLM {quant['teacher_gib_before']:.2f} GiB -> "
            f"{quant['teacher_gib_after']:.2f} GiB on the device, float "
            f"matrices left besides the embedding: "
            f"{quant['teacher_float_matrices']}; student head in int8 "
            f"before the steps: {quant['student_head_int8']} (LoRA: "
            f"{quant['lora']})")
        if (quant["teacher_float_matrices"]
                or quant["student_head_int8"] == quant["lora"]
                or not quant["teacher_gib_after"]
                < quant["teacher_gib_before"]):
            raise AssertionError(f"{stage}: the int8 options did not take: "
                                 f"{quant}")
    return dict(step_ms=ms, median_ms=med, tokens_per_s=tokens / med * 1e3,
                peak_gib=peak_gib, step_peak_gib=step_peak,
                step_start_gib=[r["start_gib"] for r in records],
                load_s=info["build_and_load_s"],
                save_s=info["save_s"], run_stage_s=wall_s,
                updates=info["optimizer_updates"], launches=launches,
                launches_per_microbatch=per_mb, first=first, plain_first=plain,
                rel=rel, last=last, quantization=quant,
                memory=next((r["memory"] for r in records if "memory" in r),
                            None))


def _trainable_state(out: str, keys) -> dict:
    state = torch.load(os.path.join(out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    return {k: state[k] for k in keys}


def fused_args(data: dict) -> list:
    """[stages fused]'s flags on top of stage 2's: Adafactor and the fused
    step on the repeated-sample dataset."""
    return ["--data_path", data["align_same"], "--optimizer", "adafactor",
            "--fused_update", "true"]


def fused_stage(config, argv, data, root, tok, dev, card, adamw,
                dist_raw) -> dict:
    """[stages fused]: stage 2 again from its config as written, plus
    `--optimizer adafactor --fused_update`, accumulation 2 and 4
    microbatches (2 updates), on the repeated-sample dataset, with a
    checkpoint after update 1.  Global gating (the config sets no gating
    groups) gives the warning and the folded backward.  Then a second run
    auto-resumes from that checkpoint alone and must reach the same
    second update as the uninterrupted one."""
    import warnings

    from llavamod_tpu_torch.train.run import run_stage

    whole = os.path.join(root, "out_align_fused")
    cut = os.path.join(root, "out_align_fused_resumed")
    extra = fused_args(data) + ["--save_steps", "1"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = drive_stage("align", config, argv + extra
                          + ["--output_dir", whole], tok, dev, card,
                          tag="align fused", memory_call=0)
    dist = dist_fused_check(dist_raw.pop("fused"), res, whole, card,
                            dist_raw["wall_s"])
    warned = any("global gating" in str(w.message) for w in caught)
    log(f"[stages] align fused: global-gating warning given: {warned}; peak "
        f"of the steps {res['step_peak_gib']:.2f} GiB vs "
        f"{adamw['step_peak_gib']:.2f} with AdamW (the run's peaks "
        f"{res['peak_gib']:.2f} vs {adamw['peak_gib']:.2f}); "
        f"update median {res['median_ms']:.1f} ms, AdamW microbatch median "
        f"{adamw['median_ms']:.1f} ms; on {card}")
    if not warned:
        raise AssertionError("the fused stage with global gating did not "
                             "warn")

    # auto-resume: only the checkpoint after update 1 survives; the
    # uninterrupted run's trained tensors wait on the card
    ckpt = os.path.join(whole, "checkpoint-1")
    os.makedirs(cut)
    os.rename(ckpt, os.path.join(cut, "checkpoint-1"))
    margs, dargs, targs, salign = parse_stage(
        "align", config, argv + extra + ["--output_dir", cut])
    saved = torch.load(os.path.join(cut, "checkpoint-1", "state.pt"),
                       map_location="cpu", weights_only=True, mmap=True)
    keys = [k for k in saved["opt"]["default"]["state"]]
    keys += [k for k in saved["opt"]["projector"]["state"]]
    after1 = {k: saved["model"][k] for k in keys}
    w_whole = {k: v.to(dev) for k, v in _trainable_state(whole, keys).items()}
    a = _read_json_lines(os.path.join(whole, "metrics.jsonl"))[-1]
    shutil.rmtree(whole)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        run_stage("align", margs, dargs, targs, salign=salign, tokenizer=tok,
                  device=dev)
        resume_s = time.perf_counter() - t0
    with open(os.path.join(cut, "run_info.json")) as f:
        info = json.load(f)
    b = _read_json_lines(os.path.join(cut, "metrics.jsonl"))[-1]
    w_cut = _trainable_state(cut, keys)
    same = sum((w_whole[k] == w_cut[k].to(dev)).sum().item() for k in keys)
    total = sum(w_whole[k].numel() for k in keys)
    rel = {"loss": abs(b["loss"] - a["loss"]) / abs(a["loss"]),
           "grad_norm": abs(b["grad_norm"] - a["grad_norm"])
           / abs(a["grad_norm"]),
           "params": math.sqrt(_sq_dist(w_cut, w_whole, dev))
           / math.sqrt(_sq_dist(w_whole, after1, dev))}
    log(f"[stages] align fused resume: from {info['resumed_from']} "
        f"({info['microbatches']} microbatches, {resume_s:.1f} s): update 2 "
        f"loss {b['loss']:.6f} vs {a['loss']:.6f} (rel {rel['loss']:.2e}, "
        f"tol {RESUME_LOSS_REL_TOL}), grad_norm rel {rel['grad_norm']:.2e} "
        f"(tol {RESUME_GRAD_NORM_REL_TOL}); weights after it "
        f"||w_resumed - w_whole|| / ||w_whole - w_update1|| "
        f"{rel['params']:.3e} (tol {RESUME_PARAM_REL_TOL}), {same} of "
        f"{total} trainable entries bitwise equal")
    if not (info["resumed_from"] and info["optimizer_updates"] == 2
            and info["microbatches"] == 2
            and rel["loss"] <= RESUME_LOSS_REL_TOL
            and rel["grad_norm"] <= RESUME_GRAD_NORM_REL_TOL
            and rel["params"] <= RESUME_PARAM_REL_TOL):
        raise AssertionError(f"the resumed fused run differs: {rel} {info}")
    del saved, after1, w_whole, w_cut
    shutil.rmtree(cut)
    return dict(res, resume=dict(rel=rel, bitwise_equal=same / total,
                                 seconds=resume_s), warned=warned, dist=dist)


def check_stage1_outputs(policy: str, out: str, dev, margs=None,
                         seed=None, tag: str = "pretrain") -> None:
    """Stage 1 moved the projectors only (the image projector, and the
    video projector where the model has one), and its mm_projector.bin
    reads back bitwise: the starting model is `build_llava` of `policy`
    (an HF directory or a preset) with the stage's arguments and seed, built
    again here."""
    from llavamod_tpu_torch.train.checkpoint import load_mm_projector
    from llavamod_tpu_torch.train.run import build_llava

    if margs is None:
        margs, seed, _ = stage_seed("pretrain")
    cfg, model = build_llava(policy, margs, seed=seed, device=dev)
    before = model.state_dict()
    after = torch.load(os.path.join(out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    if before.keys() != after.keys():
        raise AssertionError(f"{tag} changed the model's keys")
    moved = sorted(k for k in before
                   if not torch.equal(before[k], after[k].to(dev)))
    frozen_moved = [k for k in moved if not k.startswith(
        ("projector.", "video_projector."))]
    video_moved = [k for k in moved if k.startswith("video_projector.")]
    saved = {k[len("projector."):]: v for k, v in after.items()
             if k.startswith("projector.")}
    proj = load_mm_projector(os.path.join(out, "mm_projector.bin"),
                             cfg.projector_type, template=saved)
    proj_ok = proj.keys() == saved.keys() and all(
        torch.equal(v, saved[k]) for k, v in proj.items())
    log(f"[stages] {tag}: {len(moved)} tensors moved (all projector: "
        f"{not frozen_moved}; video projector {len(video_moved)}), "
        f"{len(before) - len(moved)} decoder and tower tensors bitwise "
        f"unchanged; mm_projector.bin ({cfg.projector_type}, {len(proj)} "
        f"entries) reads back bitwise the saved projector: {proj_ok}")
    del before, model
    gc.collect()
    torch.cuda.empty_cache()
    if (frozen_moved or not moved or not proj_ok
            or (cfg.video_projector_type is not None) != bool(video_moved)):
        raise AssertionError(f"{tag} outputs: moved {frozen_moved[:4]}, "
                             f"video {video_moved[:2]}, projector file ok "
                             f"{proj_ok}")


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


# ---------------------------------------------------------------------------
# eval phase: the eval CLI, the single-query API and the chat CLI on the
# student that stage 3 has just trained
# ---------------------------------------------------------------------------

EVAL_QUESTIONS = 20
# [lora]'s adapter and merged runs answer one batch alike (20 until PR 14,
# cut for the time limit)
LORA_EVAL_QUESTIONS = 8
EVAL_TEMPLATE = "qwen"          # the "version" of the stage configs
POPE_CATEGORIES = ("adversarial", "popular", "random")
EVAL_OBJECTS = ("dog", "cat", "car", "person", "chair", "bicycle", "bottle",
                "cup", "bird", "umbrella")
ANSWER_KEYS = {"question_id", "prompt", "text", "answer_id", "model_id",
               "metadata"}


def write_eval_data(root: str, n: int = EVAL_QUESTIONS):
    """n POPE-format questions over the stage images (question_id, image,
    text, category) and the POPE label files, one per category, with
    seeded yes / no labels."""
    rng = np.random.RandomState(SEED + 9)
    os.makedirs(root, exist_ok=True)
    questions = [{"question_id": i, "image": f"{i % STAGE_IMAGES}.png",
                  "text": f"Is there a {EVAL_OBJECTS[i % len(EVAL_OBJECTS)]}"
                          f" in the image?",
                  "category": POPE_CATEGORIES[i % len(POPE_CATEGORIES)]}
                 for i in range(n)]
    qfile = os.path.join(root, "eval_questions.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in questions)
    ann = os.path.join(root, "pope_annotations")
    os.makedirs(ann)
    for cat in POPE_CATEGORIES:
        with open(os.path.join(ann, f"coco_pope_{cat}.json"), "w") as f:
            f.writelines(json.dumps({"question_id": q["question_id"],
                                     "label": ("yes", "no")[rng.randint(2)]})
                         + "\n" for q in questions if q["category"] == cat)
    return questions, qfile, ann


def _eval_counts() -> dict:
    from llavamod_tpu_torch.ops.decode_attention import flash_decode
    from llavamod_tpu_torch.ops.flash_attention import flash_fwd

    return {"flash_fwd": flash_fwd.launches,
            "flash_decode": flash_decode.launches,
            "flash_decode_int8": flash_decode.int8_launches}


def _reset_eval_counts():
    from llavamod_tpu_torch.ops.decode_attention import flash_decode

    _reset_launch_counts()
    flash_decode.launches = flash_decode.int8_launches = 0


@contextlib.contextmanager
def recorded_eval(rec: dict):
    """Within the block: every prefill and every run of decode steps that
    `generation.generate` makes records its time (the card synchronised
    before and after) and its K1/K2 launches; every gating forward its
    launches; `VQARunner.run` its wall time; `generate` the ids of every
    batch; and the decoder counts its attention calls that take the plain
    path."""
    from llavamod_tpu_torch import generation
    from llavamod_tpu_torch.eval import generate as eval_generate
    from llavamod_tpu_torch.models.llm import decoder

    runner_cls = eval_generate.VQARunner
    rec.update(prefill=[], decode=[], gating=[], ids=[], plain=0, run_s=0.0)

    def timed(kind, fn, steps=lambda a: 1):
        def wrapper(*a, **k):
            before = _eval_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[kind].append(dict(
                ms=(time.perf_counter() - t0) * 1e3, steps=steps(a),
                launches={n: c - before[n] for n, c in _eval_counts().items()}))
            return out
        return wrapper

    orig = {"run": runner_cls.run, "generate": eval_generate.generate,
            "attention": decoder.dot_product_attention}

    def run(self, *a, **k):
        t0 = time.perf_counter()
        out = orig["run"](self, *a, **k)
        rec["run_s"] += time.perf_counter() - t0
        return out

    def generate(*a, **k):
        ids = orig["generate"](*a, **k)
        rec["ids"].append(ids)
        return ids

    def attention(q, k, v, **kw):
        impl = kw.get("impl", "auto")
        if impl == "xla" or (impl == "auto" and not (
                q.is_cuda and kw.get("bias") is None
                and kw.get("mask") is None)):
            rec["plain"] += 1
        return orig["attention"](q, k, v, **kw)

    patches = [
        (generation, "_prefill", timed("prefill", generation._prefill)),
        (generation, "_decode_steps",
         timed("decode", generation._decode_steps, steps=lambda a: a[3])),
        (runner_cls, "_collect_gating",
         timed("gating", runner_cls._collect_gating)),
        (runner_cls, "run", run),
        (eval_generate, "generate", generate),
        (decoder, "dot_product_attention", attention),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield rec
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)


def drive_eval(tag: str, argv: list, tok, card: str, layers: int,
               int8_cache: bool, questions: int = EVAL_QUESTIONS):
    """One `eval.cli generate` run (counts set to 0 just before, read just
    after); checks that every prefill and gating forward launched K1 on
    every layer, every decode step K2 on every layer (in its int8 mode with
    an int8 cache) and that no decoder attention took the plain path.
    Returns the runner and the run's numbers."""
    from llavamod_tpu_torch.eval import cli as eval_cli

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    with recorded_eval(rec):
        _reset_eval_counts()
        t0 = time.perf_counter()
        runner = eval_cli.main(["generate"] + argv, tokenizer=tok)
        wall_s = time.perf_counter() - t0
        launches = _eval_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    batches = len(rec["prefill"])
    steps = sum(d["steps"] for d in rec["decode"])
    gating = len(rec["gating"])
    expect = {"flash_fwd": layers * (batches + gating),
              "flash_decode": layers * steps,
              "flash_decode_int8": layers * steps if int8_cache else 0}
    per_call = all(r["launches"]["flash_fwd"] == layers
                   for r in rec["prefill"] + rec["gating"]) and all(
        r["launches"]["flash_decode"] == layers * r["steps"]
        for r in rec["decode"])
    prefill_ms = statistics.median(r["ms"] for r in rec["prefill"])
    decode_ms = sum(r["ms"] for r in rec["decode"]) / max(steps, 1)
    stats = dict(
        questions_per_s=questions / rec["run_s"], run_s=rec["run_s"],
        load_s=wall_s - rec["run_s"], batches=batches, decode_steps=steps,
        image_ms_per_batch=runner.timings["image"] / batches * 1e3,
        encode_ms_per_batch=runner.timings["encode"] / batches * 1e3,
        prefill_ms=prefill_ms,
        prefill_ms_all=[r["ms"] for r in rec["prefill"]],
        decode_ms_per_step=decode_ms,
        gating_ms=[r["ms"] for r in rec["gating"]], peak_gib=peak_gib,
        launches=launches, expected_launches=expect,
        plain_attention_calls=rec["plain"], card=card)
    log(f"{tag} {questions} questions in {batches} batches of "
        f"{runner.batch_size}: {stats['questions_per_s']:.3f} questions/s "
        f"(run {rec['run_s']:.2f} s; load {stats['load_s']:.2f} s); batch "
        f"building host ms per batch: image load + preprocess (C++) "
        f"{stats['image_ms_per_batch']:.1f}, tokenize + splice + copy to "
        f"the card {stats['encode_ms_per_batch']:.1f}; prefill (B="
        f"{runner.batch_size}, T={runner.max_prompt_len}, tower + LLM + head)"
        f" {prefill_ms:.2f} ms median of {batches}; decode "
        f"{decode_ms:.3f} ms/step over {steps} steps; gating forward ms "
        f"{' / '.join(f'{t:.1f}' for t in stats['gating_ms'])}; peak device "
        f"memory {peak_gib:.2f} GiB; on {card}")
    ids = np.concatenate(rec["ids"])
    values, counts = np.unique(ids, return_counts=True)
    top = sorted(zip(counts.tolist(), values.tolist()), reverse=True)[:3]
    log(f"{tag} generated ids (padded rows included): {ids.size}, "
        f"{len(values)} distinct, most frequent "
        + ", ".join(f"{v} = {tok.decode([v])!r} x{c}" for c, v in top))
    log(f"{tag} launches {launches} (expected {expect}: {layers} layers x "
        f"({batches} prefills + {gating} gating forwards) for K1, {layers} "
        f"layers x {steps} decode steps for K2); decoder attention calls on "
        f"the plain path: {rec['plain']}")
    if launches != expect or not per_call or rec["plain"]:
        raise AssertionError(f"{tag}: the eval run did not go through the "
                             f"kernels on every layer: {launches} vs {expect}"
                             f", per call {per_call}, plain {rec['plain']}")
    return runner, rec, stats


def check_answers(tag: str, path: str, questions: list) -> list:
    rows = _read_json_lines(path)
    want = [q["question_id"] for q in questions]
    ok = ([r["question_id"] for r in rows] == want
          and all(set(r) == ANSWER_KEYS and isinstance(r["text"], str)
                  for r in rows))
    log(f"{tag} {len(rows)} answer rows in question order with the "
        f"reference schema: {ok}; first answer {rows[0]['text'][:80]!r}")
    if not ok:
        raise AssertionError(f"{tag}: answer rows {rows[:2]}")
    return rows


def check_gating(path: str, questions: list, shape: tuple) -> None:
    dump = np.load(path)
    sums = [float(np.abs(dump[k].sum(-1) - 1.0).max()) for k in dump.files]
    ok = (sorted(dump.files, key=int) == [str(q["question_id"])
                                          for q in questions]
          and all(dump[k].shape == shape and dump[k].dtype == np.float32
                  for k in dump.files) and max(sums) <= 1e-3)
    log(f"[eval] gating dump: {len(dump.files)} question ids, each "
        f"{dump[dump.files[0]].shape} {dump[dump.files[0]].dtype} (need "
        f"{shape}); rows sum to 1 within {max(sums):.2e} (tol 1e-3)")
    if not ok:
        raise AssertionError(f"gating dump {path} malformed")


def eval_phase(model_dir: str, image_dir: str, root: str, tok, card: str):
    """The eval CLI on stage 3's student at full width: bf16 generation with
    the router dump, its first batch's prefill logits against plain
    attention, the int8 KV cache, W8A8 with the int8 cache, the chunk
    fan-out through merge / convert / score, one single query and the chat
    CLI streamed and not."""
    from llavamod_tpu_torch.eval import cli as eval_cli
    from llavamod_tpu_torch.eval import run_llava
    from llavamod_tpu_torch.serve import cli as chat_cli

    questions, qfile, ann = write_eval_data(root)
    moe = _moe_config(model_dir)
    layers = _num_layers(model_dir)
    common = ["--model-path", model_dir, "--question-file", qfile,
              "--image-folder", image_dir, "--conv-mode", EVAL_TEMPLATE,
              "--batch-size", str(MAX_BATCH), "--max-new-tokens",
              str(NEW_TOKENS)]

    def outputs(name):
        return (os.path.join(root, f"answers_{name}.jsonl"),
                os.path.join(root, f"gating_{name}.npz"))

    def run(tag, name, *extra):
        answers, gating = outputs(name)
        return drive_eval(tag, common + ["--answers-file", answers,
                                         "--dump-gating", gating, *extra],
                          tok, card, layers, int8_cache="int8" in extra)

    out = {}
    runner, rec16, out["bf16"] = run("[eval]", "bf16")
    check_answers("[eval]", outputs("bf16")[0], questions)
    check_gating(outputs("bf16")[1], questions,
                 (len(moe["moe_layers"]), PROMPT_LEN, moe["moe_num_experts"]))

    first = questions[:MAX_BATCH]
    images = [runner._load_image(q, image_dir)[1] for q in first]
    batch = runner._encode_batch(
        [runner.build_prompt(q["text"], True) for q in first], images)
    first_logits, out["logits_rel"] = prefill_logits_vs_plain(
        runner.cfg, runner.model, batch, "[eval] first batch:")
    out["bf16_first_logits"] = first_logits.cpu()
    del runner, batch
    gc.collect()
    torch.cuda.empty_cache()

    runner, rec8c, out["int8_cache"] = run(
        "[eval int8-cache]", "int8_cache", "--kv-cache-dtype", "int8")
    del runner
    check_answers("[eval int8-cache]", outputs("int8_cache")[0], questions)
    real = [min(MAX_BATCH, EVAL_QUESTIONS - i)
            for i in range(0, EVAL_QUESTIONS, MAX_BATCH)]
    ids16 = np.concatenate([g[:n] for g, n in zip(rec16["ids"], real)])
    ids8 = np.concatenate([g[:n] for g, n in zip(rec8c["ids"], real)])
    first_equal = int((ids16[:, 0] == ids8[:, 0]).sum())
    lead = [int(np.argmin(np.append(a == b, False)))
            for a, b in zip(ids8, ids16)]
    later = float((ids16[:, 1:] == ids8[:, 1:]).mean())
    out["bf16_rows"] = ids16
    out["int8_cache"].update(first_token_rows_equal=first_equal,
                             leading_tokens_equal=lead,
                             later_positions_equal=later)
    log(f"[eval int8-cache] first generated token equal to the bf16-cache "
        f"run's in {first_equal} of {len(ids16)} rows (prefill reads no "
        f"cache: need all); tokens equal from the start per row {lead} of "
        f"{NEW_TOKENS}; later positions equal {later:.3f} (not checked)")
    if first_equal != len(ids16):
        raise AssertionError("the int8-cache run's first tokens differ")

    runner, _, out["int8"] = run("[eval int8]", "int8", "--quant", "int8",
                                 "--kv-cache-dtype", "int8")
    del runner
    check_answers("[eval int8]", outputs("int8")[0], questions)

    # chunk fan-out -> merge -> convert -> score (host commands)
    chunks = []
    for idx in range(2):
        chunks.append(os.path.join(root, f"answers_chunk{idx}.jsonl"))
        eval_cli.main(["generate"] + common + [
            "--answers-file", chunks[-1], "--num-chunks", "2",
            "--chunk-idx", str(idx)], tokenizer=tok)
        gc.collect()
        torch.cuda.empty_cache()
    merged = os.path.join(root, "answers_merged.jsonl")
    eval_cli.main(["merge", "--inputs", *chunks, "--output", merged])
    ids = [r["question_id"] for r in _read_json_lines(merged)]
    gqa = os.path.join(root, "gqa_predictions.json")
    eval_cli.main(["convert", "--benchmark", "gqa", "--answers", merged,
                   "--output", gqa])
    with open(gqa) as f:
        converted = json.load(f)
    pope = os.path.join(root, "pope_score.json")
    eval_cli.main(["score", "--benchmark", "pope", "--question-file", qfile,
                   "--answers", merged, "--annotation-dir", ann,
                   "--output", pope])
    with open(pope) as f:
        out["pope"] = json.load(f)
    counted = sum(m[k] for m in out["pope"].values()
                  for k in ("TP", "FP", "TN", "FN"))
    log(f"[eval host] merge of 2 fan-out chunks: {len(ids)} rows, every "
        f"question id once: {sorted(ids) == list(range(EVAL_QUESTIONS))}; "
        f"convert gqa: {len(converted)} predictions; score pope per "
        f"category {out['pope']} counts {counted} answers (need "
        f"{EVAL_QUESTIONS})")
    if not (sorted(ids) == list(range(EVAL_QUESTIONS))
            and len(converted) == EVAL_QUESTIONS
            and counted == EVAL_QUESTIONS):
        raise AssertionError("merge / convert / score on the fan-out answers")

    # single query and the chat CLI
    image = os.path.join(image_dir, "0.png")
    runner = run_llava.load_runner(model_dir, conv_mode=EVAL_TEMPLATE,
                                   tokenizer=tok)
    t0 = time.perf_counter()
    text = run_llava.single_query(model_dir, image, "Describe the image.",
                                  conv_mode=EVAL_TEMPLATE,
                                  max_new_tokens=NEW_TOKENS, runner=runner)
    out["single_query_s"] = time.perf_counter() - t0
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[eval chat] single_query with a preloaded runner in "
        f"{out['single_query_s']:.2f} s: {text[:80]!r}")
    if not isinstance(text, str):
        raise AssertionError(f"single_query returned {text!r}")
    replies, stdin = {}, sys.stdin
    for chunk in (8, 0):
        sys.stdin = io.StringIO("What is in the image?\n"
                                "And what colour is it?\n\n")
        try:
            replies[chunk] = chat_cli.main(
                ["--model-path", model_dir, "--image-file", image,
                 "--conv-mode", EVAL_TEMPLATE, "--temperature", "0",
                 "--max-new-tokens", str(NEW_TOKENS), "--stream-chunk",
                 str(chunk)], tokenizer=tok)
        finally:
            sys.stdin = stdin
        gc.collect()
        torch.cuda.empty_cache()
    out["chat_replies_equal"] = replies[8] == replies[0]
    log(f"[eval chat] 2 scripted turns, --stream-chunk 8 vs 0: greedy "
        f"replies equal {out['chat_replies_equal']} "
        f"({[len(r) for r in replies[0]]} characters)")
    if len(replies[0]) != 2 or not out["chat_replies_equal"]:
        raise AssertionError(f"chat replies differ: {replies}")
    return out


def hf_roundtrip_phase(student_dir: str, image_dir: str, root: str, tok,
                       card: str, native_ids, native_logits, dev) -> dict:
    """[hf]: stage 3's MoE student through Hugging Face directories and the
    checkpoint tools.  `export_hf_llava` writes it (DeepSpeed MoE keys, the
    embedded moe block); its tower becomes an HF CLIP directory
    (`vision_model.*`) through the smoke's inverse of
    `vision_params_from_hf`, held by a round trip on the card;
    the eval CLI with `--model-path hf_dir --vision-path clip_dir`
    (`load_pretrained_model(hf_dir, vision_path=clip_dir)`) builds the
    student on the card and answers the 20 questions again: every row
    token for token the native bf16 run's and the first batch's prefill
    logits bitwise its logits, K1 / K2 launches as expected and no plain
    attention.  Then tools/import_hf, tools/consolidate and
    tools/extract_mm_projector on the HF directory: llm.* and projector.*
    bitwise stage 3's."""
    from llavamod_tpu_torch.interop.hf import (
        export_hf_llava,
        vision_params_from_hf,
    )
    from llavamod_tpu_torch.models import builder
    from llavamod_tpu_torch.tools import consolidate, extract_mm_projector
    from llavamod_tpu_torch.tools import import_hf
    from llavamod_tpu_torch.train.checkpoint import load_mm_projector

    out = {}
    cfg, model = builder.load_model(student_dir, device=dev)
    state = model.state_dict()
    hf_dir = os.path.join(root, "llava-mod-2b-hf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_hf_llava(hf_dir, cfg, state)
    out["export"] = dict(write_s=time.perf_counter() - t0,
                         bytes=dir_bytes(hf_dir))
    with open(os.path.join(hf_dir, "config.json")) as f:
        moe_block = json.load(f).get("moe", {})
    keys = torch.load(os.path.join(hf_dir, "pytorch_model.bin"),
                      map_location="cpu", weights_only=True, mmap=True).keys()
    layer0 = "model.layers.0.mlp.deepspeed_moe."
    naming = (layer0 + "gate.wg.weight" in keys
              and layer0 + "experts.deepspeed_experts.3.up_proj.weight" in keys
              and "model.layers.1.mlp.up_proj.weight" in keys)
    log(f"[hf] export_hf_llava of stage 3's student: "
        f"{out['export']['bytes'] / 1e9:.3f} GB in "
        f"{out['export']['write_s']:.1f} s, {len(keys)} keys, DeepSpeed MoE "
        f"naming {naming}, moe block layers {moe_block.get('moe_layers_idx')}"
        f" experts {moe_block.get('num_experts', [None])[0]}")
    if not (naming and moe_block.get("moe_enable")
            and moe_block["moe_layers_idx"] == list(cfg.llm.moe_layers)):
        raise AssertionError("the HF export lacks the MoE layout")

    tower = {k[len("vision."):]: v for k, v in state.items()
             if k.startswith("vision.")}
    clip_dir = os.path.join(root, "clip-vit-l-336")
    hf_tower = vision_params_to_hf(tower, cfg.vision)
    back = vision_params_from_hf(hf_tower, cfg.vision)
    tower_equal = back.keys() == tower.keys() and all(
        torch.equal(back[k], tower[k]) for k in tower)
    os.makedirs(clip_dir)
    v = cfg.vision
    with open(os.path.join(clip_dir, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPVisionModel"],
                   "model_type": "clip_vision_model",
                   "hidden_size": v.hidden_size,
                   "intermediate_size": v.intermediate_size,
                   "num_hidden_layers": v.num_layers,
                   "num_attention_heads": v.num_heads,
                   "image_size": v.image_size, "patch_size": v.patch_size,
                   "hidden_act": v.activation,
                   "layer_norm_eps": v.layer_norm_eps,
                   "torch_dtype": "bfloat16"}, f, indent=2)
    t0 = time.perf_counter()
    write_safetensors(os.path.join(clip_dir, "model.safetensors"), hf_tower)
    out["clip"] = dict(write_s=time.perf_counter() - t0,
                       bytes=dir_bytes(clip_dir), roundtrip_equal=tower_equal)
    log(f"[hf] stage 3's tower as an HF CLIP directory: "
        f"{out['clip']['bytes'] / 1e9:.3f} GB in {out['clip']['write_s']:.2f}"
        f" s; vision_params_from_hf of it bitwise the tower on the card: "
        f"{tower_equal}")
    if not tower_equal:
        raise AssertionError("the CLIP layout does not round-trip")
    student = {k: v for k, v in state.items()
               if k.split(".")[0] in ("llm", "projector")}
    del model, state, back, hf_tower, tower
    gc.collect()
    torch.cuda.empty_cache()

    # the eval CLI from the HF directory, the tower from vision_path
    qfile = os.path.join(root, "eval_questions.jsonl")
    answers = os.path.join(root, "answers_hf.jsonl")
    argv = ["--model-path", hf_dir, "--vision-path", clip_dir,
            "--question-file", qfile, "--image-folder", image_dir,
            "--conv-mode", EVAL_TEMPLATE, "--batch-size", str(MAX_BATCH),
            "--max-new-tokens", str(NEW_TOKENS), "--answers-file", answers]
    runner, rec, out["eval"] = drive_eval(
        "[hf eval]", argv, tok, card, cfg.llm.num_layers, int8_cache=False)
    vision_name = runner.cfg.vision.name
    first = _read_json_lines(qfile)[:MAX_BATCH]
    batch = runner._encode_batch(
        [runner.build_prompt(q["text"], True) for q in first],
        [runner._load_image(q, image_dir)[1] for q in first])
    logits, _ = prefill_logits_vs_plain(runner.cfg, runner.model, batch,
                                        "[hf eval] first batch:")
    logits_equal = torch.equal(logits.cpu(), native_logits)
    del runner, batch
    gc.collect()
    torch.cuda.empty_cache()
    real = [min(MAX_BATCH, EVAL_QUESTIONS - i)
            for i in range(0, EVAL_QUESTIONS, MAX_BATCH)]
    ids = np.concatenate([g[:n] for g, n in zip(rec["ids"], real)])
    rows_equal = int((ids == native_ids).all(axis=1).sum())
    texts = [r["text"] for r in _read_json_lines(answers)]
    native = [r["text"] for r in _read_json_lines(
        os.path.join(root, "answers_bf16.jsonl"))]
    out["eval"].update(rows_equal=rows_equal, texts_equal=texts == native,
                       first_logits_equal=logits_equal, tower=vision_name)
    log(f"[hf eval] eval.cli generate --model-path <HF dir> --vision-path "
        f"<CLIP dir> "
        f"(tower config {vision_name}): generated rows token for token the "
        f"native bf16 run's in {rows_equal} of {len(native_ids)}; answer "
        f"texts equal {texts == native}; the first batch's prefill "
        f"last-position logits bitwise the native run's: {logits_equal}")
    if rows_equal != len(native_ids) or texts != native or not logits_equal:
        raise AssertionError("the HF-loaded student answers differently")

    # the tools on the HF directory
    def check_native(tag, path, seconds):
        loaded = torch.load(os.path.join(path, builder.WEIGHTS_NAME),
                            map_location="cpu", weights_only=True, mmap=True)
        equal = sum(bool(torch.equal(loaded[k].to(dev), v))
                    for k, v in student.items())
        size = dir_bytes(path)
        log(f"[hf tools] {tag}: {size / 1e9:.3f} GB in {seconds:.1f} s; "
            f"{equal} of {len(student)} llm.* / projector.* entries bitwise "
            f"stage 3's")
        if equal != len(student):
            raise AssertionError(f"{tag}: the native copy differs")
        return dict(seconds=seconds, bytes=size, entries_equal=equal)

    native1 = os.path.join(root, "student_import_hf")
    t0 = time.perf_counter()
    import_hf.main(["--hf-path", hf_dir, "--output", native1])
    out["import_hf"] = check_native("import_hf", native1,
                                    time.perf_counter() - t0)
    shutil.rmtree(native1)
    native2 = os.path.join(root, "student_consolidated")
    t0 = time.perf_counter()
    consolidate.main(["--src", hf_dir, "--dst", native2])
    out["consolidate"] = check_native("consolidate", native2,
                                      time.perf_counter() - t0)
    shutil.rmtree(native2)
    proj_bin = os.path.join(root, "extracted", "mm_projector.bin")
    t0 = time.perf_counter()
    extract_mm_projector.main(["--model-path", hf_dir, "--output", proj_bin])
    seconds = time.perf_counter() - t0
    proj = load_mm_projector(proj_bin, cfg.projector_type)
    proj_equal = proj.keys() == {k[len("projector."):] for k in student
                                 if k.startswith("projector.")} and all(
        torch.equal(v.to(dev), student["projector." + k].float())
        for k, v in proj.items())
    out["extract_mm_projector"] = dict(seconds=seconds,
                                       bytes=os.path.getsize(proj_bin),
                                       equal=proj_equal)
    log(f"[hf tools] extract_mm_projector: {len(proj)} tensors in "
        f"{seconds:.2f} s, loads through train/checkpoint.py and equals "
        f"stage 3's projector (widened to f32): {proj_equal}")
    if not proj_equal:
        raise AssertionError("the extracted projector differs")
    shutil.rmtree(hf_dir)
    return out


# ---------------------------------------------------------------------------
# [lora]: stage 2 with LoRA adapters, tools.merge_lora, --model-base
# ---------------------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each entry of `x` (8 significand bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@contextlib.contextmanager
def watched_lora(record: dict):
    """Within the block, `run_stage`'s adapters are recorded as they are
    added, with a host copy of every weight they target; before the final
    save merges them in, every target is compared bitwise with that copy,
    and the adapters' `b` entries that moved are counted."""
    from llavamod_tpu_torch.train import run

    add, save = run.maybe_add_lora, run.final_save

    def adding(model, margs, seed):
        lora, lcfg = add(model, margs, seed)
        if lora is not None:
            weights = dict(model.named_parameters())
            record.update(targets=list(lora.targets), before={
                t: weights[t].detach().to("cpu", copy=True)
                for t in lora.targets})
        return lora, lcfg

    def saving(output_dir, cfg, state, tcfg, *args, **kwargs):
        if state.lora is not None:
            from torch.distributed.tensor import DTensor

            weights = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in state.model.named_parameters()
                       if k in record["before"]}
            record.update(
                unchanged=sum(bool(torch.equal(weights[t], record["before"][t]
                                               .to(weights[t].device)))
                              for t in record["targets"]),
                b_moved=sum(bool(state.lora.pair(t).b.any())
                            for t in record["targets"]),
                params=sum(p.numel() for p in state.lora.parameters()),
                bytes=sum(p.numel() * p.element_size()
                          for p in state.lora.parameters()),
                dtype=str(next(state.lora.parameters()).dtype))
        return save(output_dir, cfg, state, tcfg, *args, **kwargs)

    run.maybe_add_lora, run.final_save = adding, saving
    try:
        yield record
    finally:
        run.maybe_add_lora, run.final_save = add, save


def lora_phase(config: str, argv: list, data: dict, root: str, tok, dev,
               card: str, plain_stage2: dict, dist_raw: dict) -> dict:
    """[lora]: stage 2 from its config as written plus `--lora_enable True`
    (r 128, alpha 256, FFN adapters, the experts' per expert) from stage
    2a's output: the numbers beside the same call's stage 2 without
    adapters; every adapted base weight bitwise unchanged before the final
    save and every `b` moved.  The upcycled base is built again as
    `run_stage` builds it (same seed) and saved; `tools.merge_lora` merges
    `out/adapter` onto it, and each adapted weight must equal the stage's
    merged output within one bf16 ulp of the larger of the entry and the
    rank-r product; the routers the run trained come through
    non_lora_trainables.bin bitwise.  Then `eval.cli generate
    --model-path out/adapter --model-base <base>` and the same on the
    merged directory must answer LORA_EVAL_QUESTIONS questions token for
    token alike,
    with the first batch's prefill logits bitwise equal."""
    from llavamod_tpu_torch.models.builder import save_model
    from llavamod_tpu_torch.models.lora import NON_LORA_FILE, load_lora_adapter
    from llavamod_tpu_torch.tools import merge_lora
    from llavamod_tpu_torch.train import run

    out = os.path.join(root, "out_align_lora")
    argv = argv + ["--lora_enable", "True", "--output_dir", out]
    record = {}
    with watched_lora(record):
        res = drive_stage("align", config, argv, tok, dev, card,
                          tag="align lora")
    n = len(record["targets"])
    log(f"[lora] adapters: {n} targets (FFN; experts stacked), "
        f"{record['params']:,} parameters, {record['bytes'] / 2**20:.1f} MiB "
        f"({record['dtype']}) on the card; adapter_model.bin "
        f"{dir_bytes(os.path.join(out, 'adapter')) / 2**20:.1f} MiB (f32); "
        f"adapted base weights bitwise unchanged before the final save "
        f"{record['unchanged']} of {n}; b adapters moved {record['b_moved']} "
        f"of {n}")
    log(f"[lora] microbatch median {res['median_ms']:.1f} ms vs "
        f"{plain_stage2['median_ms']:.1f} without adapters; tokens/s "
        f"{res['tokens_per_s']:.1f} vs {plain_stage2['tokens_per_s']:.1f}; "
        f"peak {res['peak_gib']:.2f} GiB vs {plain_stage2['peak_gib']:.2f} "
        f"(of the steps {res['step_peak_gib']:.2f} vs "
        f"{plain_stage2['step_peak_gib']:.2f}); on {card}")
    if record["unchanged"] != n or record["b_moved"] != n or not n:
        raise AssertionError(f"[lora] adapted weights moved or adapters did "
                             f"not: {record['unchanged']}, "
                             f"{record['b_moved']} of {n}")
    dist = dist_lora_check(dist_raw, res, out, card)
    del dist_raw

    # the base as run_stage built it: stage 2a's output, upcycled
    margs, _, targs, salign = parse_stage("align", config, argv)
    t0 = time.perf_counter()
    cfg, model = run.build_llava(salign.policy_model_name_or_path, margs,
                                 seed=targs.seed, device=dev)
    cfg, model = run.maybe_upcycle(cfg, model, margs)
    weights = dict(model.named_parameters())
    rebuilt = sum(bool(torch.equal(weights[t], record["before"][t].to(dev)))
                  for t in record["targets"])
    base = save_model(os.path.join(root, "lora_base"), model)
    base_s = time.perf_counter() - t0
    del weights, record["before"]
    shutil.rmtree(salign.policy_model_name_or_path)   # stage 2a's output
    t0 = time.perf_counter()
    merged = merge_lora.main(["--model-path", os.path.join(out, "adapter"),
                              "--model-base", base, "--save-path",
                              os.path.join(root, "lora_merged")])
    merge_s = time.perf_counter() - t0
    # the stage merges its bf16 adapters with a bf16 product, the tool the
    # f32 file's with an f32 one: the two differ by the rounding of the
    # rank-r product, so a difference is held to one bf16 ulp of the
    # larger of the merged entry and scaling * (a @ b) (the merged entry
    # alone is the bound unless the two addends cancel)
    lora, lcfg = load_lora_adapter(os.path.join(out, "adapter"), model)
    a = torch.load(os.path.join(out, "model.pt"), map_location="cpu",
                   weights_only=True, mmap=True)
    b = torch.load(os.path.join(merged, "model.pt"), map_location="cpu",
                   weights_only=True, mmap=True)
    # the run's other trained tensors (the routers and the projector) reach
    # the tool's merge through non_lora_trainables.bin
    extra = torch.load(os.path.join(out, "adapter", NON_LORA_FILE),
                       map_location="cpu", weights_only=True)
    base_state = model.state_dict()
    routers = [k for k in a if k.endswith(".mlp.router")]
    carried_keys = routers + [k for k in a if k.startswith("projector.")]
    wg = [k for k in extra if k.endswith("deepspeed_moe.gate.wg.weight")]
    carried = sum(bool(torch.equal(a[k], b[k])) for k in carried_keys)
    moved = sum(not torch.equal(a[k].to(dev), base_state[k])
                for k in routers)
    log(f"[lora] {NON_LORA_FILE}: {len(extra)} entries, {len(wg)} routers "
        f"as '...mlp.deepspeed_moe.gate.wg.weight', the projector in "
        f"mm_projector.bin's keys; routers and projector tensors of the "
        f"tool's merge bitwise the stage's merged output: {carried} of "
        f"{len(carried_keys)}; routers moved from the base: {moved} of "
        f"{len(routers)}")
    if not (routers and len(wg) == len(routers) == moved
            and carried == len(carried_keys)):
        raise AssertionError(f"[lora] the routers did not travel: file "
                             f"{len(wg)}, carried {carried} of "
                             f"{len(carried_keys)}, moved {moved} of "
                             f"{len(routers)}")
    del extra, base_state
    equal = within = within_result = 0
    worst = 0.0
    for t in record["targets"]:
        x, y = a[t].to(dev).float(), b[t].to(dev).float()
        pair = lora.pair(t)
        prod = (lcfg.scaling * torch.matmul(pair.a, pair.b)).abs()
        equal += bool(torch.equal(x, y))
        diff = (x - y).abs()
        result_ulp = _bf16_ulp(torch.maximum(x.abs(), y.abs()))
        within_result += bool((diff <= result_ulp).all())
        ulp = _bf16_ulp(torch.maximum(torch.maximum(x.abs(), y.abs()), prod))
        within += bool((diff <= ulp).all())
        worst = max(worst, float((diff / ulp).max()))
        del x, y, prod, diff, ulp, result_ulp
    log(f"[lora] base rebuilt from the seed ({rebuilt} of {n} adapted "
        f"weights bitwise the run's) and saved in {base_s:.1f} s; "
        f"tools.merge_lora onto it in {merge_s:.1f} s; adapted weights of "
        f"the tool's merge vs the stage's merged output: {equal} of {n} "
        f"bitwise, {within} of {n} within one bf16 ulp of the larger of the "
        f"entry and scaling * (a @ b) (largest difference {worst:.3f} of "
        f"that ulp), {within_result} of {n} within one ulp of the entry")
    if rebuilt != n or within != n:
        raise AssertionError(f"[lora] merge_lora differs: rebuilt {rebuilt}, "
                             f"within an ulp {within} of {n}")
    del a, b, lora, model
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(os.path.join(out, "model.pt"))

    questions, qfile, _ = write_eval_data(os.path.join(root, "lora_eval"),
                                          LORA_EVAL_QUESTIONS)
    common = ["--question-file", qfile, "--image-folder", data["images"],
              "--conv-mode", EVAL_TEMPLATE, "--batch-size", str(MAX_BATCH),
              "--max-new-tokens", str(NEW_TOKENS)]
    runs = {}
    for name, model_args in (
            ("adapter", ["--model-path", os.path.join(out, "adapter"),
                         "--model-base", base]),
            ("merged", ["--model-path", merged])):
        answers = os.path.join(root, f"answers_lora_{name}.jsonl")
        runner, rec, stats = drive_eval(
            f"[eval lora {name}]", model_args + common + ["--answers-file",
                                                          answers],
            tok, card, _num_layers(base), int8_cache=False,
            questions=LORA_EVAL_QUESTIONS)
        check_answers(f"[eval lora {name}]", answers, questions)
        # the rows alone prove little (the smoke's student answers with
        # spaces): the first batch's prefill logits are compared too
        first = questions[:MAX_BATCH]
        batch = runner._encode_batch(
            [runner.build_prompt(q["text"], True) for q in first],
            [runner._load_image(q, data["images"])[1] for q in first])
        logits, _ = prefill_logits_vs_plain(
            runner.cfg, runner.model, batch, f"[eval lora {name}] first batch:")
        del runner, batch
        runs[name] = dict(stats, ids=np.concatenate(rec["ids"]),
                          texts=[r["text"] for r in _read_json_lines(answers)],
                          logits=logits.cpu())
    same = bool(np.array_equal(runs["adapter"]["ids"], runs["merged"]["ids"])
                and runs["adapter"]["texts"] == runs["merged"]["texts"])
    same_logits = bool(torch.equal(runs["adapter"]["logits"],
                                   runs["merged"]["logits"]))
    log(f"[eval lora] --model-path out/adapter --model-base <base> vs the "
        f"merged directory: answers token for token equal: {same}; first "
        f"batch's prefill logits bitwise equal: {same_logits}")
    if not (same and same_logits):
        raise AssertionError("[lora] the adapter + base answers differ from "
                             "the merged model's")
    for d in (out, base, merged):
        shutil.rmtree(d)
    for r in runs.values():
        del r["ids"], r["texts"], r["logits"]
    return dict(res, adapter=dict(
        targets=n, params=record["params"], bytes=record["bytes"],
        unchanged=record["unchanged"], b_moved=record["b_moved"]),
        base_s=base_s, merge_s=merge_s, merge_equal=equal,
        merge_within_ulp=within, eval=runs, dist=dist)


# ---------------------------------------------------------------------------
# [projectors]: stage 1 with S2 + the Q-Former, and with the video projector
# ---------------------------------------------------------------------------

# a preset (--s2 and --video_tower build one): Qwen1.5-1.8B's widths at 6
# of its 24 layers, the smoke's depth cut for [projectors] (PERF §4)
PROJECTOR_LLM = "qwen1.5-1.8b-6-layers"
PROJECTOR_LAYERS = 6
VIDEO_FRAMES = 8
PROJECTOR_EVAL_QUESTIONS = 8


def write_video_data(root: str, images: str, n: int = 8) -> str:
    """Video records in the reference format ('video': its frame files,
    '<video>' in the first human turn; a conversation template, since the
    plain one keeps only an <image>): each video the 8 seeded stage PNGs in
    a seeded order, 100-600 characters of text."""
    rng = np.random.RandomState(SEED + 11)
    frames = sorted(os.listdir(images))
    records = [{"id": i, "video": [frames[j] for j in rng.permutation(
        len(frames))[:VIDEO_FRAMES]], "conversations": [
        {"from": "human", "value": "<video>\n" + _words(rng, 60) + "?"},
        {"from": "gpt", "value": _words(rng, rng.randint(100, 500))}]}
        for i in range(n)]
    path = os.path.join(root, "video.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def projectors_phase(data: dict, root: str, tok, dev, card: str) -> dict:
    """[projectors]: two stage-1 runs through `run_stage` from the stage-1
    config as written on a preset of Qwen1.5-1.8B's widths cut to
    PROJECTOR_LAYERS layers (seeded, f32 as the trainer builds presets): `--s2 True --s2_scales 336,672 --image_projector_type
    qformer2_64`, and `--video_tower clip-vit-l-336 --video_projector_type
    simple_in1_out1` with the three summaries on video records (8 frames x
    (100 + 2) + 576 = 1,392 video tokens).  Each: 2 updates, K1/K3/K4 every
    microbatch, the plain-attention first microbatch, only projector.* /
    video_projector.* moved, mm_projector.bin read back bitwise.  Then the
    Q-Former output (cast to bf16, as the kernels take it) answers one
    batch of 8 questions through the eval CLI."""
    from llavamod_tpu_torch.models import builder
    from llavamod_tpu_torch.models.llm.config import QWEN1_5_1_8B, llm_configs

    if PROJECTOR_LLM not in llm_configs:
        llm_configs.register(PROJECTOR_LLM, QWEN1_5_1_8B.replace(
            name=PROJECTOR_LLM, num_layers=PROJECTOR_LAYERS))
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, dict(STAGE_CONFIGS)["pretrain"])
    common = ["--model_name_or_path", PROJECTOR_LLM, "--image_folder",
              data["images"], "--max_steps", str(STAGE_MICROBATCHES),
              "--gradient_accumulation_steps", str(STAGE_ACCUM)]
    runs = {
        "s2_qformer": ["--data_path", data["pretrain"], "--s2", "True",
                       "--s2_scales", "336,672", "--image_projector_type",
                       "qformer2_64"],
        "video": ["--data_path", write_video_data(root, data["images"]),
                  "--version", "qwen", "--video_tower", "clip-vit-l-336",
                  "--video_projector_type", "simple_in1_out1",
                  "--video_global_proj", "True", "--video_temproal_proj",
                  "True", "--video_spatial_proj", "True"],
    }
    results = {}
    for name, extra in runs.items():
        out = os.path.join(root, f"out_{name}")
        argv = common + extra + ["--output_dir", out]
        tag = f"pretrain {name}"
        results[name] = drive_stage("pretrain", config, argv, tok, dev, card,
                                    tag=tag)
        margs, _, targs, _ = parse_stage("pretrain", config, argv)
        with open(os.path.join(out, builder.CONFIG_NAME)) as f:
            cfg = builder.config_from_dict(json.load(f))
        log(f"[projectors] {name}: {cfg.projector_type}, s2 {cfg.s2_scales}, "
            f"video {cfg.video_projector_type}; {cfg.num_image_tokens} image "
            f"+ {cfg.num_video_tokens} video tokens a sample; vision features "
            f"{cfg.vision_feature_dim} wide")
        check_stage1_outputs(PROJECTOR_LLM, out, dev, margs, targs.seed, tag)
        if name == "s2_qformer":
            _, model = builder.load_model(out, device=dev,
                                          dtype=torch.bfloat16)
            bf16 = builder.save_model(out + "_bf16", model)
            del model
            shutil.rmtree(out)
            questions, qfile, _ = write_eval_data(
                os.path.join(root, "projector_eval"), PROJECTOR_EVAL_QUESTIONS)
            answers = os.path.join(root, "answers_qformer.jsonl")
            runner, _, results["eval_qformer"] = drive_eval(
                "[eval qformer]", ["--model-path", bf16, "--question-file",
                                   qfile, "--image-folder", data["images"],
                                   "--conv-mode", EVAL_TEMPLATE,
                                   "--batch-size", str(MAX_BATCH),
                                   "--max-new-tokens", str(NEW_TOKENS),
                                   "--answers-file", answers],
                tok, card, _num_layers(bf16), int8_cache=False,
                questions=PROJECTOR_EVAL_QUESTIONS)
            del runner
            check_answers("[eval qformer]", answers, questions)
            shutil.rmtree(bf16)
        else:
            shutil.rmtree(out)
        gc.collect()
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# stage 2a from the port's recipe, and the [data] phase
# ---------------------------------------------------------------------------

D2D_RECIPE = "llavamod_tpu_torch/recipes/train/dense2dense_distillation.sh"
D2D_TRAINABLE_PREDICTED = (1.8e9, 1.9e9)   # Qwen1.5-1.8B untied + mlp2x_gelu
DATA_TIMED_EPOCHS = 3                       # 4 batches of B=8 an epoch


def d2d_stage(env: dict, common: list, policy: str, tok, dev,
              card: str) -> dict:
    """Stage 2a as the port's dense2dense_distillation.sh writes it (its
    flags read out of the file with `recipes.recipe_commands`, as the CPU
    test reads them), with the smoke's `common` flags on top: the dense
    student from stage 1's output distilled from the HF teacher, the whole
    LLM and the projector trained.  Beside `drive_stage`'s checks: the
    output config is dense, the tower is bitwise stage 1's, only LLM and
    projector tensors moved (every matrix among them), and the trainable
    parameters are counted."""
    from llavamod_tpu_torch.recipes import STAGES, recipe_commands

    here = os.path.dirname(os.path.abspath(__file__))
    (module, argv), = recipe_commands(os.path.join(here, D2D_RECIPE), env)
    log(f"[stages] align d2d: {D2D_RECIPE} -> python -m {module} "
        f"{' '.join(argv)}; the smoke adds {' '.join(common)}")
    res = drive_stage(STAGES[module], None, argv + common, tok, dev, card,
                      tag="align d2d")
    out = env["OUTPUT_DIR"]
    from llavamod_tpu_torch.models.builder import CONFIG_NAME

    with open(os.path.join(out, CONFIG_NAME)) as f:
        llm = json.load(f)["llm"]
    before = torch.load(os.path.join(policy, "model.pt"), map_location="cpu",
                        weights_only=True, mmap=True)
    after = torch.load(os.path.join(out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    if before.keys() != after.keys():
        raise AssertionError("stage 2a changed the model's keys")
    tower = [k for k in before if k.startswith("vision.")]
    trained = [k for k in before if not k.startswith("vision.")]
    tower_same = sum(bool(torch.equal(before[k], after[k])) for k in tower)
    moved = {k for k in trained
             if not torch.equal(before[k].to(dev), after[k].to(dev))}
    # every matrix must move; a norm weight near 1.0 does not move in bf16
    # under 2 updates at lr 2e-5 (its ulp is 2^-8)
    still = [k for k in trained if k not in moved and after[k].dim() >= 2]
    n_trainable = sum(after[k].numel() for k in trained)
    dense = not llm.get("moe_layers") and not llm.get("moe_num_experts")
    lo, hi = D2D_TRAINABLE_PREDICTED
    log(f"[stages] align d2d: output config dense: {dense} (moe_layers "
        f"{llm.get('moe_layers')}, moe_num_experts "
        f"{llm.get('moe_num_experts')}); tower {tower_same} of {len(tower)} "
        f"tensors bitwise stage 1's; LLM + projector tensors moved "
        f"{len(moved)} of {len(trained)} (matrices unmoved: {len(still)}); "
        f"trainable parameters {n_trainable:,} ({n_trainable / 1e9:.3f} B; "
        f"predicted {lo / 1e9:.1f}-{hi / 1e9:.1f} B)")
    del before, after
    if not (dense and tower_same == len(tower) and moved and not still):
        raise AssertionError(f"stage 2a: dense {dense}, tower {tower_same} "
                             f"of {len(tower)}, moved {len(moved)}, matrices "
                             f"unmoved {still[:4]}")
    return dict(res, trainable=n_trainable, dense=dense,
                tower_unchanged=tower_same, moved=len(moved))


def data_phase(config: str, data: dict, tok, dev, card: str,
               stage1_ms: float) -> dict:
    """[data]: the trainer's loader as stage 1 builds it (train/run.py's
    `build_data_module` from the stage-1 config: B=8, 8 worker threads,
    the length-free random sampler) over the stage-1 dataset and its seeded
    PNGs, through `DevicePrefetcher` onto the card, with the consumer idle:
    one epoch of warm-up, then DATA_TIMED_EPOCHS epochs timed.  Once on the
    C++ preprocessor and once with LLAVAMOD_NO_NATIVE=1: the host ms to
    build one batch on one worker (median of the timed builds) and the ms
    per batch delivered to the card (wall time / batches), beside stage 1's
    microbatch.  The PIL pass's batches are counted; no other batch of the
    run may take the PIL path."""
    from llavamod_tpu_torch import native
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import QWEN1_5_1_8B
    from llavamod_tpu_torch.models.vision.vit import CLIP_VIT_L_336
    from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
    from llavamod_tpu_torch.train import run
    from llavamod_tpu_torch.train.loader import infinite_batches

    margs, dargs, targs, _ = parse_stage("pretrain", config, [
        "--data_path", data["pretrain"], "--image_folder", data["images"]])
    cfg = LlavaConfig(llm=QWEN1_5_1_8B, vision=CLIP_VIT_L_336,
                      projector_type=margs.image_projector_type,
                      max_images=1)
    out = {}
    for path in ("native", "pil"):
        if path == "pil":
            os.environ["LLAVAMOD_NO_NATIVE"] = "1"
        before = dict(native.counts)
        try:
            loader = run.build_data_module("pretrain", margs, dargs, targs,
                                           tok, cfg)
            per_epoch = len(loader)
            builds, lock, build = [], threading.Lock(), loader._build

            def timed(idx, build=build, builds=builds, lock=lock):
                t0 = time.perf_counter()
                batch = build(idx)
                with lock:
                    builds.append((time.perf_counter() - t0) * 1e3)
                return batch

            loader._build = timed
            host = infinite_batches(loader)
            it = iter(DevicePrefetcher(host, device=dev))
            for _ in range(per_epoch):                 # warm-up epoch
                next(it)
            torch.cuda.synchronize()
            warm = len(builds)
            n = per_epoch * DATA_TIMED_EPOCHS
            t0 = time.perf_counter()
            for _ in range(n):
                batch = next(it)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            host.close()
        finally:
            os.environ.pop("LLAVAMOD_NO_NATIVE", None)
        timed_builds = builds[warm:warm + n]
        counts = {k: native.counts[k] - before[k] for k in before}
        out[path] = dict(
            build_ms=statistics.median(timed_builds), builds=len(timed_builds),
            delivered_ms=wall_ms / n, batches=n, prep_batches=counts,
            pixels=list(batch["pixels"].shape))
        log(f"[data] {path}: loader of the stage-1 config (B="
            f"{targs.per_device_train_batch_size}, "
            f"{targs.dataloader_num_workers} worker threads, pixels "
            f"{out[path]['pixels']}): host ms to build a batch "
            f"{out[path]['build_ms']:.1f} (median of "
            f"{len(timed_builds)} after a warm-up epoch), delivered to the "
            f"card {out[path]['delivered_ms']:.1f} ms a batch over {n} "
            f"batches; stage 1's microbatch {stage1_ms:.1f} ms "
            f"({out[path]['delivered_ms'] / stage1_ms:.3f} of it); "
            f"preprocessor calls {counts}; on {card}")
        if len(timed_builds) < 8 or (path == "native" and counts["pil"]) \
                or (path == "pil" and counts["native"]):
            raise AssertionError(f"[data] {path}: {len(timed_builds)} timed "
                                 f"builds, preprocessor calls {counts}")
    out["stage1_microbatch_ms"] = stage1_ms
    return out


def dist_profile(prof, wall_ms: float) -> dict:
    """Device ms of one profiled microbatch: all kernels, the NCCL
    kernels, and FSDP2's copy-in / copy-out operations (the `fsdp::`
    custom ops, every kernel they launch), with the top kernels."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in kernels)
    nccl = [r for r in kernels if "nccl" in r[0].lower()]
    # FSDP2's hooks by kind, every unit summed: the gathers before a
    # forward (copy-in, all-gather, copy-out) and before a backward, and
    # the gradient reductions (copy-in, reduce-scatter, copy-out)
    fsdp = {}
    for e in rows:
        kind = e.key.split(" (")[0]
        if e.device_type == DeviceType.CPU and kind in (
                "FSDP::pre_forward", "FSDP::pre_backward",
                "FSDP::post_backward_reduce"):
            f = fsdp.setdefault(kind, dict(ms=0.0, host_ms=0.0, count=0))
            f["ms"] += e.device_time_total / 1e3
            f["host_ms"] += e.cpu_time_total / 1e3
            f["count"] += e.count
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    collectives = tp_collectives(rows)
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    return dict(wall_ms=wall_ms, busy_ms=busy, kernels=sum(r[2] for r in
                                                           kernels),
                nccl_ms=sum(r[1] for r in nccl),
                nccl_kernels=sum(r[2] for r in nccl),
                nccl_names=sorted({r[0][:60] for r in nccl}),
                fsdp_ops=fsdp, collectives=collectives,
                top=[dict(name=n[:80], ms=ms, count=c) for n, ms, c in top],
                top_host=[dict(name=e.key[:80],
                               ms=e.self_cpu_time_total / 1e3, count=e.count)
                          for e in host])


def dist_worker(spec_path: str) -> int:
    """The worker of [dist], [dist fused] and [dist lora], one rank of
    `torch.distributed.run`: stage 2 through `run_stage` (which joins the
    NCCL group torchrun describes and shards both models) with the
    stand-in tokenizer, once for the spec or once for each of its `runs`
    in turn (one process start and NCCL group for them all), each step
    counted as in the stages phase; rank 0 writes the numbers to the
    spec's `result` file."""
    with open(spec_path) as f:
        spec = json.load(f)
    runs = spec.get("runs")
    results = ({r["name"]: _dist_stage(r) for r in runs} if runs
               else _dist_stage(spec))
    if int(os.environ.get("RANK", "0")) == 0:
        with open(spec["result"], "w") as f:
            json.dump({"runs": results} if runs else results, f)
    return 0


def _dist_stage(spec: dict) -> dict:
    """One `run_stage("align")` of the worker on `spec` (config, argv,
    profile_call, memory_call); its numbers."""
    import warnings

    from llavamod_tpu_torch.parallel import collectives
    from llavamod_tpu_torch.parallel.sharding import is_sharded
    from llavamod_tpu_torch.train import fused_steps, run, steps

    gc.collect()
    torch.cuda.empty_cache()
    margs, dargs, targs, extra = parse_stage("align", spec["config"],
                                             spec["argv"])
    records, saves, sharded = [], [], []
    calls = {"gather_rows": 0, "exchange": 0}
    makers = ((steps, "make_align_step"),
              (fused_steps, "make_fused_align_step"))
    originals = dict(save=run._save_periodic,
                     **{n: getattr(collectives.ParallelContext, n)
                        for n in calls},
                     **{n: getattr(mod, n) for mod, n in makers})

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        originals["save"](*a, **k)
        torch.cuda.synchronize()
        saves.append(time.perf_counter() - t0)

    def counting(name):
        def call(self, *a, **k):
            calls[name] += 1
            return originals[name](self, *a, **k)
        return call

    def checking(name):
        def make(*a, **k):
            step = originals[name](*a, **k)

            def checked(state, teacher, batch):
                if not sharded:
                    sharded.append(dict(student=is_sharded(state.model),
                                        teacher=is_sharded(teacher)))
                return step(state, teacher, batch)
            return checked
        return make

    run._save_periodic = timed_save
    for mod, n in makers:
        setattr(mod, n, checking(n))
    for n in calls:
        setattr(collectives.ParallelContext, n, counting(n))
    torch.cuda.reset_peak_memory_stats()
    lora = {}
    try:
        with counted_steps(records, spec.get("profile_call"),
                           spec.get("memory_call")), \
                watched_lora(lora), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _reset_launch_counts()
            run.run_stage("align", margs, dargs, targs, salign=extra,
                          tokenizer=StandInTokenizer(), device="cuda")
            launches = _launch_counts()
    finally:
        run._save_periodic = originals["save"]
        for mod, n in makers:
            setattr(mod, n, originals[n])
        for n in calls:
            setattr(collectives.ParallelContext, n, originals[n])
    peak = max([torch.cuda.max_memory_allocated() / 2**30]
               + [max(r["prior_peak_gib"], r["peak_gib"]) for r in records])
    lora.pop("before", None)
    digests = {}
    if spec.get("remove_after") and int(os.environ.get("RANK", "0")) == 0:
        shutil.rmtree(spec["remove_after"])
    if spec.get("digest_outputs") and int(os.environ.get("RANK", "0")) == 0:
        from llavamod_tpu_torch.models.lora import NON_LORA_FILE

        out = targs.output_dir
        for name in ("model.pt", os.path.join("adapter", "adapter_model.bin"),
                     os.path.join("adapter", NON_LORA_FILE)):
            path = os.path.join(out, name)
            if os.path.exists(path):
                digests[os.path.basename(name)] = file_digests(path)
                os.remove(path)
    return dict(records=records, launches=launches, peak_gib=peak,
                digests=digests,
                checkpoint_s=saves, sharded=sharded, collective_calls=calls,
                world=int(os.environ["WORLD_SIZE"]), lora=lora,
                warned=any("global gating" in str(w.message)
                           for w in caught),
                torch=torch.__version__,
                nccl=".".join(map(str, torch.cuda.nccl.version())))


def _torchrun(spec: dict, root: str, tag: str) -> dict:
    """One `torch.distributed.run --standalone --nproc_per_node 1` of the
    worker on `spec`; raises if it fails; returns its result."""
    spec = dict(spec, result=os.path.join(root, f"dist_{tag}.json"))
    spec_path = os.path.join(root, f"dist_{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", os.path.abspath(__file__), "--dist-worker",
         spec_path], env=env, cwd=here, capture_output=True, text=True,
        timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("[mesh]", "[ckpt]", "[run]", "[data]")):
            log(f"[dist] {tag} | {line}")
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-8000:])
        raise AssertionError(f"[dist] {tag}: torchrun exited "
                             f"{proc.returncode}")
    with open(spec["result"]) as f:
        out = json.load(f)
    out["wall_s"] = wall
    return out


def dist_runs(config: str, argv: list, root: str, dev, card: str,
              more: dict) -> dict:
    """[dist], before the single-process stage 2 (so that its checkpoint
    and the stages' files fit the disk together): stage 2 (`argv`: the
    stages phase's, from 2a's output) under a one-rank NCCL torchrun, with
    a sharded checkpoint after update 1; rank 0's model.pt through
    `load_pretrained_model` on the card (kept on the host for
    `dist_check`); a second torchrun resumed from the checkpoint, one
    microbatch profiled, whose worker removes the checkpoint and goes on
    to [dist fused] and [dist lora] (`more`: their argvs,
    `dist_more_runs`)."""
    from llavamod_tpu_torch.models.builder import load_pretrained_model
    from llavamod_tpu_torch.train.args import AlignArgs

    out = os.path.join(root, "out_align_dist")
    argv = argv + ["--output_dir", out, "--save_steps", str(STAGE_ACCUM)]
    margs, _, targs, extra = parse_stage("align", config, argv)
    assert isinstance(extra, AlignArgs)
    layers = _num_layers(extra.policy_model_name_or_path)
    teacher_layers = _num_layers(extra.ref_model_name_or_path)
    per_mb = {"flash_fwd": layers * (2 if targs.remat else 1)
              + teacher_layers, "flash_dq": layers, "flash_dkv": layers}
    # the student's bf16 model twice (the checkpoint's shards and model.pt)
    # and AdamW's two bf16 moments of the 2.035 B trainable entries (the
    # accumulator is zero at the update boundary and is not written)
    need = 2 * 6.73 + 2 * 2 * 2.035 + 1.0
    free = shutil.disk_usage(root).free / 1e9
    log(f"[dist] needs ~{need:.1f} GB of disk, {free:.1f} GB free")
    if free < need:
        raise AssertionError(f"[dist] needs {need:.1f} GB, {free:.1f} free")
    spec = dict(config=config, argv=argv)
    first = _torchrun(dict(spec, memory_call=0), root, "run")
    log_time("[dist] first torchrun")
    lines = _read_json_lines(os.path.join(out, "metrics.jsonl"))
    with open(os.path.join(out, "run_info.json")) as f:
        info = json.load(f)
    ckpt = os.path.join(out, f"checkpoint-{STAGE_ACCUM}")
    ckpt_gb = dir_bytes(ckpt) / 1e9
    _, model, _, _, _ = load_pretrained_model(out, device=dev,
                                              tokenizer=StandInTokenizer())
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    loaded_on = str(next(model.parameters()).device)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    more = dist_more_runs(config, more, root, first=dict(
        spec, name="resumed", profile_call=1, remove_after=ckpt))
    resumed = dict(more.pop("resumed"), wall_s=more["wall_s"])
    lines2 = _read_json_lines(os.path.join(out, "metrics.jsonl"))
    with open(os.path.join(out, "run_info.json")) as f:
        info2 = json.load(f)
    again = torch.load(os.path.join(out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    resumed_same = sum(torch.equal(v, state[k]) for k, v in again.items())
    del again
    return dict(out=out, first=first, lines=lines, info=info, state=state,
                loaded_on=loaded_on, ckpt_gb=ckpt_gb, resumed=resumed,
                lines2=lines2, info2=info2, resumed_same=resumed_same,
                per_mb=per_mb, tokens=targs.per_device_train_batch_size
                * targs.model_max_length, more=more)


def file_digests(path: str) -> dict:
    """{entry: 'dtype shape blake2b'} of every tensor of a torch.save'd
    dict (model.pt, adapter_model.bin, ...): equal digests are bitwise
    equal entries.  Hashed in threads (hashlib releases the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)

    def digest(item):
        k, v = item
        raw = v.detach().contiguous().view(-1).view(torch.uint8).numpy()
        return k, (f"{v.dtype} {tuple(v.shape)} "
                   f"{hashlib.blake2b(raw, digest_size=20).hexdigest()}")
    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(digest, state.items()))


def _bitwise(a: dict, b: dict) -> tuple:
    """(entries of `a` equal to `b`'s, entries of `b`) of two
    `file_digests`; keys must agree."""
    if a.keys() != b.keys():
        raise AssertionError(f"keys differ: {sorted(a.keys() ^ b.keys())[:4]}")
    return sum(v == b[k] for k, v in a.items()), len(b)


def dist_more_runs(config: str, argvs: dict, root: str, first: dict
                   ) -> dict:
    """[dist fused] and [dist lora], beside [dist] and before the single-
    process stage 2b: one one-rank NCCL torchrun whose worker calls
    `run_stage` for `first` ([dist]'s resumed run, whose checkpoint it
    then removes), `argvs["fused"]` ([stages fused]'s argv: Adafactor, the
    fused step, 2 updates of 2 folded microbatches, the repeated sample)
    and `argvs["lora"]` ([lora]'s: `--lora_enable True`, r 128) in turn;
    the fused run's first update records its allocations.  The worker
    digests rank 0's model.pt and adapter files and removes them before
    the next run writes (the card machine's disk); the metrics and
    run_info.json are read here and the outputs removed:
    `dist_fused_check` and `dist_lora_check` hold them against the
    single-process runs of this call."""
    outs = {n: os.path.join(root, f"out_align_{n}_dist") for n in argvs}
    runs = [first] + [dict(name=n, config=config, digest_outputs=True,
                           memory_call=0 if n == "fused" else None,
                           argv=argvs[n] + ["--output_dir", outs[n]])
                      for n in argvs]
    raw = _torchrun(dict(runs=runs), root, "more")
    log_time("[dist] resumed, [dist fused], [dist lora] torchrun")
    got = {}
    for n, out in outs.items():
        with open(os.path.join(out, "run_info.json")) as f:
            info = json.load(f)
        got[n] = dict(raw["runs"][n], info=info,
                      lines=_read_json_lines(os.path.join(out,
                                                          "metrics.jsonl")))
        shutil.rmtree(out)
    got["resumed"] = raw["runs"][first["name"]]
    got["wall_s"] = raw["wall_s"]
    return got


def _updates_rel(got: list, want: list) -> list:
    return [{k: abs(g[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")}
            for g, w in zip(got, want)]


def dist_fused_check(raw: dict, single: dict, single_out: str, card: str,
                     wall_s: float) -> dict:
    """[dist fused] against the same call's single-process [stages fused]
    (`single`, its output in `single_out` before anything is removed):
    both updates' loss and grad_norm, rank 0's model.pt, K1 / K3 / K4 an
    update, update ms, peak GiB and the first update's allocations by
    site, the global-gating warning.  Prints the numbers; raises on a
    failed check."""
    recs, info = raw["records"], raw["info"]
    per = single["launches_per_microbatch"]
    lines = raw["lines"]
    want = _read_json_lines(os.path.join(single_out, "metrics.jsonl"))
    rel = _updates_rel(lines, want)
    bitwise_metrics = all(g[k] == w[k] for g, w in zip(lines, want)
                          for k in w if k not in ("step", "sec_per_step"))
    same, n = _bitwise(raw["digests"]["model.pt"], file_digests(
        os.path.join(single_out, "model.pt")))
    ms = [r["ms"] for r in recs]
    med = statistics.median(ms[1:])     # as drive_stage: after the first
    mem, smem = recs[0]["memory"], single["memory"]
    log(f"[dist fused] one-rank NCCL torchrun (with [dist]'s resumed run and"
        f" [dist lora]) {wall_s:.1f} s; mesh {info.get('mesh')}, backend {info.get('backend')}, "
        f"FSDP2-wrapped {raw['sharded']}; gating gathers "
        f"{raw['collective_calls']['gather_rows']}, expert exchanges "
        f"{raw['collective_calls']['exchange']}; global-gating warning given:"
        f" {raw['warned']}; load and build {info['build_and_load_s']:.1f} s, "
        f"saves {info['save_s']:.1f} s")
    log(f"[dist fused] updates against the single-process [stages fused]: "
        + "; ".join(f"update {i + 1} loss {g['loss']:.7f} vs {w['loss']:.7f}"
                    f" (rel {r['loss']:.3e}), grad_norm {g['grad_norm']:.7f}"
                    f" vs {w['grad_norm']:.7f} (rel {r['grad_norm']:.3e})"
                    for i, (g, w, r) in enumerate(zip(lines, want, rel)))
        + f"; tol {DIST_LOSS_REL_TOL}, {DIST_GRAD_NORM_REL_TOL}; every logged"
        f" metric bitwise: {bitwise_metrics}")
    log(f"[dist fused] rank 0's model.pt: {same} of {n} entries bitwise the "
        f"single-process output")
    log(f"[dist fused] update ms {' / '.join(f'{t:.1f}' for t in ms)} "
        f"(median after the first {med:.1f}) against "
        f"{single['median_ms']:.1f} single-process ({med / single['median_ms']:.3f}x); peak "
        f"{raw['peak_gib']:.2f} GiB (of the updates "
        f"{max(r['peak_gib'] for r in recs):.2f}) against "
        f"{single['peak_gib']:.2f} ({single['step_peak_gib']:.2f}): "
        f"{raw['peak_gib'] - single['peak_gib']:+.2f} GiB; on {card}")
    log(f"[dist fused] the first update's own allocations at their peak: "
        f"{mem['peak_gib']:.2f} GiB against {smem['peak_gib']:.2f} "
        f"single-process; on {card}")
    for name, m in (("dist", mem), ("single", smem)):
        for r in m["sites"]:
            log(f"[dist fused]   {name:6s} {r['gib']:7.3f} GiB {r['site']}")
    log(f"[dist fused] launches per update {[r['launches'] for r in recs]} "
        f"(the single process: {per} each)")
    if not (info.get("backend") == "nccl" and raw["world"] == 1
            and raw["sharded"] == [dict(student=True, teacher=True)]
            and raw["collective_calls"]["gather_rows"] > 0):
        raise AssertionError(f"[dist fused] did not run the sharded path: "
                             f"{info} {raw['sharded']}")
    if len(recs) != len(want) or any(r["launches"] != per for r in recs):
        raise AssertionError(f"[dist fused] launches {recs}, need {per}")
    if not (len(lines) == len(want) == 2 and raw["warned"]
            and all(r["loss"] <= DIST_LOSS_REL_TOL
                    and r["grad_norm"] <= DIST_GRAD_NORM_REL_TOL
                    for r in rel)):
        raise AssertionError(f"[dist fused] updates disagree: {rel} "
                             f"warned {raw['warned']}")
    if same != n:
        raise AssertionError(f"[dist fused] model.pt: {same} of {n} bitwise")
    return dict(update_ms=ms, median_ms=med,
                single_median_ms=single["median_ms"],
                peak_gib=raw["peak_gib"], single_peak_gib=single["peak_gib"],
                launches=raw["launches"], launches_per_update=per, rel=rel,
                bitwise_metrics=bitwise_metrics, model_bitwise=same,
                entries=n, memory=mem, warned=raw["warned"],
                load_s=info["build_and_load_s"])


def dist_lora_check(raw: dict, single: dict, single_out: str,
                    card: str) -> dict:
    """[dist lora] against the same call's single-process [lora]
    (`single`, its output in `single_out`): the first microbatch, the
    adapters, rank 0's adapter files and merged model.pt, microbatch ms,
    peak GiB and K1 / K3 / K4 a microbatch.  Raises on a failed check."""
    from llavamod_tpu_torch.models.lora import NON_LORA_FILE

    recs, info, rec = raw["records"], raw["info"], raw["lora"]
    per = single["launches_per_microbatch"]
    got = {k: v for k, v in raw["lines"][0].items()
           if k not in ("step", "sec_per_step")}
    sp = single["first"]
    rel = {k: abs(got[k] - sp[k]) / abs(sp[k]) for k in ("loss",
                                                         "grad_norm")}
    bitwise_first = all(got[k] == sp[k] for k in sp)
    files = {name: _bitwise(raw["digests"][name], file_digests(
        os.path.join(single_out, path))) for name, path in (
            ("adapter_model.bin", os.path.join("adapter",
                                               "adapter_model.bin")),
            (NON_LORA_FILE, os.path.join("adapter", NON_LORA_FILE)),
            ("model.pt", "model.pt"))}
    ms = [r["ms"] for r in recs]
    med = statistics.median(ms[1:])
    n = len(rec["targets"])
    log(f"[dist lora] mesh {info.get('mesh')}, FSDP2-wrapped "
        f"{raw['sharded']}; first microbatch against the single-process "
        f"[lora]: loss {got['loss']:.7f} vs {sp['loss']:.7f} (rel "
        f"{rel['loss']:.3e}), grad_norm {got['grad_norm']:.7f} vs "
        f"{sp['grad_norm']:.7f} (rel {rel['grad_norm']:.3e}); tol "
        f"{DIST_LOSS_REL_TOL}, {DIST_GRAD_NORM_REL_TOL}; every logged metric "
        f"bitwise: {bitwise_first}")
    log(f"[dist lora] adapted base weights bitwise unchanged before the "
        f"final save {rec['unchanged']} of {n}; b adapters moved "
        f"{rec['b_moved']} of {n}; rank 0's files bitwise the single "
        f"process's: " + ", ".join(f"{k} {a} of {b}"
                                   for k, (a, b) in files.items()))
    log(f"[dist lora] microbatch ms {' / '.join(f'{t:.1f}' for t in ms)} "
        f"(median after the first {med:.1f}) against "
        f"{single['median_ms']:.1f} single-process "
        f"({med / single['median_ms']:.3f}x); peak {raw['peak_gib']:.2f} GiB "
        f"against {single['peak_gib']:.2f}; load and build "
        f"{info['build_and_load_s']:.1f} s, saves {info['save_s']:.1f} s; "
        f"on {card}")
    log(f"[dist lora] launches per microbatch {[r['launches'] for r in recs]}"
        f" (the single process: {per} each)")
    if not (info.get("backend") == "nccl"
            and raw["sharded"] == [dict(student=True, teacher=True)]):
        raise AssertionError(f"[dist lora] did not run the sharded path: "
                             f"{info} {raw['sharded']}")
    if any(r["launches"] != per for r in recs) or \
            len(recs) != STAGE_MICROBATCHES:
        raise AssertionError(f"[dist lora] launches {recs}, need {per}")
    if not (rel["loss"] <= DIST_LOSS_REL_TOL
            and rel["grad_norm"] <= DIST_GRAD_NORM_REL_TOL
            and rec["unchanged"] == rec["b_moved"] == n and n):
        raise AssertionError(f"[dist lora] {rel} {rec}")
    if any(a != b for a, b in files.values()):
        raise AssertionError(f"[dist lora] files differ: {files}")
    return dict(step_ms=ms, median_ms=med,
                single_median_ms=single["median_ms"],
                peak_gib=raw["peak_gib"], single_peak_gib=single["peak_gib"],
                launches=raw["launches"], launches_per_microbatch=per,
                rel=rel, bitwise_first=bitwise_first,
                files_bitwise={k: list(v) for k, v in files.items()},
                load_s=info["build_and_load_s"])


def dist_check(raw: dict, single: dict, single_out: str, card: str) -> dict:
    """[dist] against the single-process stage 2 of this call (`single`,
    its output in `single_out`): prints the numbers and raises on a failed
    check; removes the [dist] output."""
    first, lines, info = raw["first"], raw["lines"], raw["info"]
    per_mb = raw["per_mb"]
    recs = first["records"]
    ms = [r["ms"] for r in recs]
    med = statistics.median(ms[1:])
    sp = single["first"]
    got = {k: v for k, v in lines[0].items()
           if k not in ("step", "sec_per_step")}
    rel = {k: abs(got[k] - sp[k]) / abs(sp[k]) for k in ("loss",
                                                         "grad_norm")}
    bitwise = all(got[k] == sp[k] for k in got)
    log(f"[dist] torch {first['torch']}, NCCL {first['nccl']}, world "
        f"{first['world']}, backend {info.get('backend')}, mesh "
        f"{info.get('mesh')}; FSDP2-wrapped {first['sharded']}; gating "
        f"gathers {first['collective_calls']['gather_rows']} and expert "
        f"exchanges {first['collective_calls']['exchange']} over the run; "
        f"on {card}")
    log(f"[dist] microbatch ms {' / '.join(f'{t:.1f}' for t in ms)} "
        f"(median after the first {med:.1f}) against {single['median_ms']:.1f}"
        f" single-process ({med / single['median_ms']:.3f}x); "
        f"{raw['tokens'] / med * 1e3:.1f} tokens/s against "
        f"{single['tokens_per_s']:.1f}; peak {first['peak_gib']:.2f} GiB "
        f"(of the steps {max(r['peak_gib'] for r in recs):.2f}) against "
        f"{single['peak_gib']:.2f} ({single['step_peak_gib']:.2f}); torchrun "
        f"{first['wall_s']:.1f} s; on {card}")
    log(f"[dist] device GiB held at each microbatch's start (weights, "
        f"optimizer state, gradients) "
        f"{' / '.join(f'{r['start_gib']:.2f}' for r in recs)} against "
        f"{' / '.join(f'{g:.2f}' for g in single['step_start_gib'])} "
        f"single-process; on {card}")
    mem, single_mem = recs[0]["memory"], single["memory"]
    log(f"[dist] the first microbatch's own allocations at their peak "
        f"(allocator history): {mem['peak_gib']:.2f} GiB against "
        f"{single_mem['peak_gib']:.2f} single-process; on {card}")
    for name, m in (("dist", mem), ("single", single_mem)):
        for r in m["sites"]:
            log(f"[dist]   {name:6s} {r['gib']:7.3f} GiB {r['site']}")
    log(f"[dist] launches per microbatch {[r['launches'] for r in recs]} "
        f"(stage 2: {per_mb} each)")
    log(f"[dist] first microbatch against the single-process stage 2: loss "
        f"{got['loss']:.7f} vs {sp['loss']:.7f} (rel {rel['loss']:.3e}, tol "
        f"{DIST_LOSS_REL_TOL}), grad_norm {got['grad_norm']:.7f} vs "
        f"{sp['grad_norm']:.7f} (rel {rel['grad_norm']:.3e}, tol "
        f"{DIST_GRAD_NORM_REL_TOL}); every logged metric bitwise: {bitwise}")
    log(f"[dist] sharded checkpoint after update 1 (checkpoint-"
        f"{STAGE_ACCUM}, {raw['ckpt_gb']:.2f} GB) written in "
        f"{first['checkpoint_s'][0]:.2f} s; load and build "
        f"{info['build_and_load_s']:.1f} s, saves {info['save_s']:.1f} s; "
        f"on {card}")
    if not (first["world"] == 1 and info.get("backend") == "nccl"
            and info.get("mesh") == dict(data=1, fsdp=1, expert=1, tensor=1,
                                         pipe=1)
            and first["sharded"] == [dict(student=True, teacher=True)]
            and first["collective_calls"]["gather_rows"] > 0
            and first["collective_calls"]["exchange"] > 0):
        raise AssertionError(f"[dist] did not run the sharded path: {info} "
                             f"{first['sharded']} {first['collective_calls']}")
    if len(recs) != STAGE_MICROBATCHES or any(r["launches"] != per_mb
                                              for r in recs):
        raise AssertionError(f"[dist] launches {recs}, need {per_mb}")
    if not (rel["loss"] <= DIST_LOSS_REL_TOL
            and rel["grad_norm"] <= DIST_GRAD_NORM_REL_TOL):
        raise AssertionError(f"[dist] first microbatch disagrees: {rel}")
    if not all(np.isfinite(v) for ln in lines for v in ln.values()) or \
            info["optimizer_updates"] != STAGE_MICROBATCHES // STAGE_ACCUM:
        raise AssertionError(f"[dist] run: {lines} {info}")

    ref = torch.load(os.path.join(single_out, "model.pt"), map_location="cpu",
                     weights_only=True, mmap=True)
    state = raw["state"]
    same = sum(torch.equal(v, ref[k]) for k, v in state.items() if k in ref)
    log(f"[dist] rank 0's model.pt through load_pretrained_model on "
        f"{raw['loaded_on']}: {len(state)} entries (single-process: "
        f"{len(ref)}), {same} bitwise the single-process stage 2 output "
        f"({same / len(ref):.4f}); the resumed run's model.pt: "
        f"{raw['resumed_same']} of {len(state)} entries bitwise the first "
        f"run's")
    if state.keys() != ref.keys():
        raise AssertionError("[dist] model.pt keys differ from stage 2's")
    del ref

    resumed, lines2, info2 = raw["resumed"], raw["lines2"], raw["info2"]
    whole, again = lines2[STAGE_ACCUM:STAGE_MICROBATCHES], \
        lines2[STAGE_MICROBATCHES:]
    rel2 = [{k: abs(b[k] - a[k]) / abs(a[k]) for k in ("loss", "grad_norm")}
            for a, b in zip(whole, again)]
    prof = resumed["records"][1]["profile"]
    log(f"[dist] resumed from {info2['resumed_from']}: microbatches "
        f"{[ln['step'] for ln in again]}, loss / grad_norm rel to the first "
        f"run {[(f'{r['loss']:.2e}', f'{r['grad_norm']:.2e}') for r in rel2]}"
        f" (tol {RESUME_LOSS_REL_TOL}, {RESUME_GRAD_NORM_REL_TOL}); the "
        f"torchrun of this run, [dist fused] and [dist lora] "
        f"{resumed['wall_s']:.1f} s")
    log(f"[dist] profiled microbatch: {prof['wall_ms']:.1f} ms wall, "
        f"{prof['busy_ms']:.1f} ms device busy over {prof['kernels']} "
        f"kernels; NCCL {prof['nccl_ms']:.3f} ms over {prof['nccl_kernels']} "
        f"kernels {prof['nccl_names']}; FSDP2 hooks (copy-in, collective, "
        f"copy-out), device / host ms: "
        + ", ".join(f"{k} {v['ms']:.3f} / {v['host_ms']:.1f} x{v['count']}"
                    for k, v in prof["fsdp_ops"].items()) + f"; on {card}")
    for r in prof["top"]:
        log(f"[dist]   {r['ms']:9.3f} ms x{r['count']:<5d} {r['name']}")
    for r in prof["top_host"]:
        log(f"[dist]   host {r['ms']:9.3f} ms x{r['count']:<5d} {r['name']}")
    if not (len(again) == len(whole) == STAGE_ACCUM
            and info2["optimizer_updates"] == STAGE_MICROBATCHES // STAGE_ACCUM
            and all(r["loss"] <= RESUME_LOSS_REL_TOL
                    and r["grad_norm"] <= RESUME_GRAD_NORM_REL_TOL
                    for r in rel2)
            and prof["nccl_kernels"] > 0):
        raise AssertionError(f"[dist] resumed run: {again} vs {whole} "
                             f"{info2} {prof['nccl_kernels']}")
    shutil.rmtree(raw["out"])
    return dict(step_ms=ms, median_ms=med,
                tokens_per_s=raw["tokens"] / med * 1e3,
                single_median_ms=single["median_ms"],
                peak_gib=first["peak_gib"], launches=first["launches"],
                launches_per_microbatch=per_mb, first=got, single_first=sp,
                rel=rel, bitwise=bitwise,
                checkpoint_s=first["checkpoint_s"][0],
                checkpoint_gb=raw["ckpt_gb"],
                load_s=info["build_and_load_s"], save_s=info["save_s"],
                model_entries_bitwise=same, resumed_rel=rel2, profile=prof,
                resumed_launches=resumed["launches"],
                torchrun_s=[first["wall_s"], resumed["wall_s"]],
                torch=first["torch"], nccl=first["nccl"], memory=mem,
                single_memory=single_mem)


# ---------------------------------------------------------------------------
# [tp]: tensor and sequence parallelism, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP_PROBE_OPS = ("all_reduce", "all_reduce_int32", "all_reduce_max",
                "all_gather", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "broadcast",
                "fsdp2_one_rank", "send_recv_staged")


def tp_probe() -> dict:
    """The gloo-on-CUDA probe, on every rank of the started group before
    anything is built: each collective the tensor group, the MoE block and
    FSDP2 run, on CUDA tensors of cuda:0; {op: "ok" or its error}."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + rank
    want_sum = sum(torch.arange(4.) + r for r in range(world))

    def fsdp2():
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.fsdp import fully_shard

        mesh = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                          mesh_dim_names=("tensor", "fsdp"))["fsdp"]
        lin = torch.nn.Linear(8, 8, device=dev)
        fully_shard(lin, mesh=mesh)
        lin(torch.ones(2, 8, device=dev)).sum().backward()
        return lin.weight.grad is not None

    def check(name):
        if name == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return torch.equal(y.cpu(), want_sum)
        if name == "all_reduce_int32":
            y = x.int()
            dist.all_reduce(y)
            return torch.equal(y.cpu(), want_sum.int())
        if name == "all_reduce_max":
            y = x.clone()
            dist.all_reduce(y, op=dist.ReduceOp.MAX)
            return torch.equal(y.cpu(), torch.arange(4.) + world - 1)
        if name == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            return all(torch.equal(p.cpu(), torch.arange(4.) + r)
                       for r, p in enumerate(parts))
        if name == "all_gather_into_tensor":
            y = x.new_empty(4 * world)
            dist.all_gather_into_tensor(y, x)
            return torch.equal(y.cpu(), torch.cat(
                [torch.arange(4.) + r for r in range(world)]))
        if name == "reduce_scatter_tensor":
            y = x.new_empty(4 // world)
            dist.reduce_scatter_tensor(y, x)
            n = 4 // world
            return torch.equal(y.cpu(), want_sum[rank * n:(rank + 1) * n])
        if name == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            n = 4 // world
            return torch.equal(y.cpu(), torch.cat(
                [(torch.arange(4.) + r)[rank * n:(rank + 1) * n]
                 for r in range(world)]))
        if name == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return torch.equal(y.cpu(), torch.arange(4.))
        if name == "fsdp2_one_rank":
            return fsdp2()
        if name == "send_recv_staged":
            # the pipeline's transport under gloo: a CUDA tensor through a
            # host buffer, rank 0 -> 1 -> 0 (parallel/collectives.py)
            buf = (x * 10).cpu() if rank == 0 else torch.empty(4)
            if rank == 0:
                dist.send(buf, 1)
                dist.recv(buf, 1)
                return torch.equal(buf.to(dev).cpu(), torch.arange(4.) * 10
                                   + 1)
            dist.recv(buf, 0)
            dist.send(buf + 1, 0)
            return torch.equal(buf, torch.arange(4.) * 10)
        raise KeyError(name)

    result = {}
    for name in TP_PROBE_OPS:
        try:
            result[name] = "ok" if check(name) else "wrong values"
        except Exception as exc:  # the probe reports every failure
            result[name] = f"{type(exc).__name__}: {str(exc)[:160]}"
        torch.cuda.synchronize()
    return result


P2P_OPS = ("send_recv_cuda", "batch_isend_irecv_cuda")


def p2p_probe_worker(result: str) -> int:
    """One of two ranks (gloo, both on cuda:0) trying gloo's point-to-point
    on CUDA tensors, each op's outcome appended to `<result>.<rank>` before
    the next starts: gloo's send and recv read and write the buffer's
    address from the host, so the attempt may kill the process, which is
    why it runs apart from the [tp] worker."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    dev = torch.device("cuda", 0)
    path = f"{result}.{rank}"
    for name in P2P_OPS:
        with open(path, "a") as f:
            f.write(json.dumps({"op": name, "state": "started"}) + "\n")
        try:
            x = (torch.arange(4., device=dev) + 5 if rank == 0
                 else torch.zeros(4, device=dev))
            if name == "send_recv_cuda":
                (dist.send(x, 1) if rank == 0 else dist.recv(x, 0))
            else:
                op = (dist.P2POp(dist.isend, x, 1) if rank == 0
                      else dist.P2POp(dist.irecv, x, 0))
                for w in dist.batch_isend_irecv([op]):
                    w.wait()
            torch.cuda.synchronize()
            ok = rank == 0 or torch.equal(x.cpu(), torch.arange(4.) + 5)
            state = "ok" if ok else "wrong values"
        except Exception as exc:  # the probe reports every failure
            state = f"{type(exc).__name__}: {str(exc)[:160]}"
        with open(path, "a") as f:
            f.write(json.dumps({"op": name, "state": state}) + "\n")
    dist.destroy_process_group()
    return 0


def p2p_probe_start(root: str):
    """Start `p2p_probe_worker` under its own two-rank torchrun."""
    result = os.path.join(root, "p2p_probe")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.abspath(__file__), "--p2p-probe",
         result], env=env, cwd=here, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    return proc, result


def p2p_probe_result(proc, result: str) -> dict:
    """{op: {rank: outcome}}, each rank's last word on each op (an op that
    started and never ended killed its process), and the exit code."""
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = "timed out"
    out = {}
    for r in (0, 1):
        try:
            with open(f"{result}.{r}") as f:
                for line in f:
                    e = json.loads(line)
                    st = e["state"]
                    out.setdefault(e["op"], {})[f"rank {r}"] = (
                        "the process died inside it" if st == "started"
                        else st)
        except OSError:
            pass
    out["exit"] = rc
    return out


TP_RANKS = 2
TP_PROFILE_CALL = 2        # the first microbatch of update 2
TP_FLAGS = ["--tensor_parallel", str(TP_RANKS), "--sequence_parallel", "true"]


# [pp]: stage 2b at --pipeline_parallel 2 in the [tp] worker (full depth:
# 12 of the student's 24 layers and 16 of the teacher's 32 a stage), B = 2
# rows as 2 microbatches of one row, gating groups of one sequence, one
# update; [tp generate]: the [tp] student's greedy generation
PP_RANKS = 2
PP_MICROBATCHES = 2
PP_ROWS = 2
PP_STEPS = 2
PP_FLAGS = ["--pipeline_parallel", str(PP_RANKS), "--pipeline_microbatches",
            str(PP_MICROBATCHES), "--per_device_train_batch_size",
            str(PP_ROWS), "--max_steps", str(PP_STEPS)]
GEN_ROWS = 8
GEN_NEW_TOKENS = 16
GEN_PROMPT = 704
# [pp generate]: [pp]'s stages generate as [tp generate] does, then
# PP_SAMPLE_TOKENS tokens at temperature 1 through `generate_stream`
PP_SAMPLE_TOKENS = 4


@contextlib.contextmanager
def sequence_gating(tokens: int):
    """Within the block the stage's upcycled student gates groups of
    `tokens` (one sequence): a pipeline microbatch of one row then gates
    as the single process does."""
    from llavamod_tpu_torch.train import run

    orig = run.maybe_upcycle

    def upcycle(cfg, model, margs):
        cfg, model = orig(cfg, model, margs)
        cfg = cfg.replace(llm=cfg.llm.replace(moe_gating_group_size=tokens))
        model.cfg, model.llm.cfg = cfg, cfg.llm
        return cfg, model

    run.maybe_upcycle = upcycle
    try:
        yield
    finally:
        run.maybe_upcycle = orig


def generate_batch(cfg, dev):
    """[tp generate]'s batch: GEN_ROWS left-padded prompts of 640-704 real
    tokens in GEN_PROMPT slots, each an image (576 slots) after its first
    real token, seeded text ids and pixels (bf16 on `dev`)."""
    from llavamod_tpu_torch.train.steps import batch_from_arrays

    rng = np.random.RandomState(SEED + 15)
    b, t, n_img = GEN_ROWS, GEN_PROMPT, cfg.num_image_tokens
    s = cfg.vision.image_size
    lengths = rng.randint(n_img + 64, t + 1, size=b)
    ids = rng.randint(10, 1000, size=(b, t)).astype(np.int32)
    seg = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), bool)
    pos = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        first = t - n
        seg[i, first:] = 1
        ids[i, :first] = 0
        img = slice(first + 1, first + 1 + n_img)
        mask[i, img] = True
        pos[i, img] = i * n_img + np.arange(n_img)
        ids[i, img] = 0
    batch = batch_from_arrays(dict(
        input_ids=ids, segment_ids=seg, image_mask=mask, image_pos=pos,
        pixels=rng.randn(b, 1, 3, s, s).astype(np.float32),
        pixel_valid=np.ones((b, 1), bool),
        labels=np.full((b, t), -100, np.int32)), device=dev)
    return batch._replace(pixels=batch.pixels.to(torch.bfloat16))


def counted_generation(model, batch, gcfg, stream: bool = False) -> dict:
    """`generation.generate` (`stream`: `generate_stream` in chunks of 4)
    of `model` on `batch` (under the active context), each prefill and run
    of decode steps timed (the card synchronised) with its K1 / K2 launches
    and the pipeline transport's transfers, the (query, KV) heads every K2
    call was handed, and the layers of every cache made."""
    from llavamod_tpu_torch import generation
    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.parallel import collectives

    rec = dict(prefill=[], decode=[], heads=set(), cache_layers=[])
    orig = dict(prefill=generation._prefill,
                decode=generation._decode_steps, flash=decoder.flash_decode,
                cache=decoder.init_cache)

    def timed(kind, fn, steps):
        def run(*a, **k):
            before = _eval_counts()
            sent = dict(collectives.transport)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[kind].append(dict(
                ms=(time.perf_counter() - t0) * 1e3, steps=steps(a),
                launches={n: c - before[n]
                          for n, c in _eval_counts().items()},
                transport={n: v - sent[n]
                           for n, v in collectives.transport.items()}))
            return out
        return run

    def flash(q, k, *a, **kw):
        rec["heads"].add((int(q.shape[1]), int(k.shape[1])))
        return orig["flash"](q, k, *a, **kw)

    def init_cache(*a, **kw):
        cache = orig["cache"](*a, **kw)
        rec["cache_layers"].append(int(cache.k.shape[0]))
        return cache

    generation._prefill = timed("prefill", orig["prefill"], lambda a: 1)
    generation._decode_steps = timed("decode", orig["decode"],
                                     lambda a: a[3])
    decoder.flash_decode, decoder.init_cache = flash, init_cache
    try:
        if stream:
            ids = np.concatenate(list(generation.generate_stream(
                model, batch, gcfg, chunk=4)), axis=1)
        else:
            ids = generation.generate(model, batch, gcfg)
    finally:
        generation._prefill = orig["prefill"]
        generation._decode_steps = orig["decode"]
        decoder.flash_decode = orig["flash"]
        decoder.init_cache = orig["cache"]
    return dict(tokens=ids.tolist(), prefill=rec["prefill"],
                decode=rec["decode"], heads=sorted(rec["heads"]),
                cache_layers=rec["cache_layers"])


def tp_generate_phase(model, pctx) -> dict:
    """[tp generate] in the [tp] worker: the student `model` that [tp] has
    just trained (FSDP2 units, the rank's tensor slices) generates
    GEN_NEW_TOKENS greedy tokens for `generate_batch` under its context."""
    from llavamod_tpu_torch.generation import GenerationConfig
    from llavamod_tpu_torch.parallel.collectives import active

    batch = generate_batch(model.cfg, torch.device("cuda", 0))
    gcfg = GenerationConfig(max_new_tokens=GEN_NEW_TOKENS)
    t0 = time.perf_counter()
    with active(pctx):
        out = counted_generation(model, batch, gcfg)
    out["seconds"] = time.perf_counter() - t0
    return out


def pp_generate_phase(model, pctx) -> dict:
    """[pp generate] in the [tp] worker, after [pp]: the stages that [pp]
    has just trained (12 of the student's 24 layers each, FSDP2 units)
    generate GEN_NEW_TOKENS greedy tokens for `generate_batch` under [pp]'s
    context, the stages in turn (parallel/pipeline.py `sequential_layers`:
    K1 on the stage's layers in the prefill, K2 on its cache slots each
    decode step), transfers staged through host buffers; then
    PP_SAMPLE_TOKENS tokens at temperature 1 through `generate_stream`
    (pipe rank 0's draw broadcast, the done flags all-reduced), the ranks'
    generators seeded apart.  The rank's peak device memory over both."""
    from llavamod_tpu_torch.generation import GenerationConfig
    from llavamod_tpu_torch.parallel.collectives import active

    batch = generate_batch(model.cfg, torch.device("cuda", 0))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with active(pctx):
        out = counted_generation(
            model, batch, GenerationConfig(max_new_tokens=GEN_NEW_TOKENS))
        torch.cuda.manual_seed(SEED + pctx.pipe_rank)
        out["sampled"] = counted_generation(
            model, batch, GenerationConfig(max_new_tokens=PP_SAMPLE_TOKENS,
                                           temperature=1.0), stream=True)
    llm = model.cfg.llm
    out.update(seconds=time.perf_counter() - t0, stage=pctx.pipe_rank,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               gating_group=llm.moe_gating_group_size,
               kv_heads=[llm.num_heads, llm.num_kv_heads],
               vocab=llm.vocab_size)
    return out


def pp_phase(spec: dict) -> dict:
    """[pp] in the [tp] worker: stage 2b at --pipeline_parallel 2 through
    `run_stage` on the same gloo group, each step counted as in the stages
    phase; after update 1 every parameter outside the decoder layers
    compared between the two stages (stage 1 against stage 0's,
    broadcast); the pipeline transport's transfers and host ms; then
    [pp generate] on the trained stages (`pp_generate_phase`)."""
    import torch.distributed as dist

    from llavamod_tpu_torch.parallel import collectives
    from llavamod_tpu_torch.parallel.pipeline import is_stage_key
    from llavamod_tpu_torch.parallel.sharding import local_tensor
    from llavamod_tpu_torch.train import run, steps

    margs, dargs, targs, extra = parse_stage("align", spec["config"],
                                             spec["pp_argv"])
    records, replicas, stage, held = [], {}, {}, {}

    @torch.no_grad()
    def compare(model):
        pctx = collectives.current()
        same = total = trained = 0
        for n, p in model.named_parameters():
            if is_stage_key(n):
                continue
            t = local_tensor(p).detach()
            ref = t.clone()
            dist.broadcast(ref, pctx.pipe_ranks[0], group=pctx.pipe_group)
            same += bool(torch.equal(ref, t))
            total += 1
            trained += p.requires_grad
        replicas.update(same=same, total=total, trained=trained)
        stage.update(rank=pctx.pipe_rank,
                     layers=list(model.llm.layers.indices))

    original = steps.make_align_step

    def make(*a, **k):
        step = original(*a, **k)
        calls = []

        def checked(state, teacher, batch):
            out = step(state, teacher, batch)
            calls.append(1)
            if len(calls) == targs.gradient_accumulation_steps:
                compare(out[0].model)
            steps_transport.update(collectives.transport)
            held.update(model=out[0].model, pctx=collectives.current())
            return out
        return checked

    steps_transport = {}
    collectives.reset_transport()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with sequence_gating(targs.model_max_length), counted_steps(records):
        original = steps.make_align_step
        steps.make_align_step = make
        try:
            _reset_launch_counts()
            run.run_stage("align", margs, dargs, targs, salign=extra,
                          tokenizer=StandInTokenizer(), device="cuda")
            launches = _launch_counts()
        finally:
            steps.make_align_step = original
    peak = max([torch.cuda.max_memory_allocated() / 2**30]
               + [max(r["prior_peak_gib"], r["peak_gib"]) for r in records])
    save_transport = {k: v - steps_transport[k] for k, v in
                      collectives.transport.items()}
    seconds = time.perf_counter() - t0
    generated = pp_generate_phase(held.pop("model"), held.pop("pctx"))
    return dict(records=records, launches=launches, peak_gib=peak,
                replicas=replicas, stage=stage, transport=steps_transport,
                save_transport=save_transport, seconds=seconds,
                generate=generated)


def tp_collectives(rows) -> dict:
    """The tensor group's collectives in a profiled microbatch (its
    `key_averages()` rows): gloo stages a CUDA tensor through the host, so
    they show as host ops (c10d / gloo) and as device copies to and from
    the host."""
    from torch.autograd import DeviceType

    ops, copies = {}, dict(ms=0.0, count=0)
    for e in rows:
        if e.device_type == DeviceType.CPU and (
                e.key.startswith(("c10d::", "gloo:")) or "nccl:" in e.key):
            ops[e.key[:60]] = dict(host_ms=e.cpu_time_total / 1e3,
                                   count=e.count)
        if e.device_type == DeviceType.CUDA and e.key.startswith(
                ("Memcpy DtoH", "Memcpy HtoD")):
            copies["ms"] += e.self_device_time_total / 1e3
            copies["count"] += e.count
    return dict(ops=ops, copies=copies)


def tp_worker(spec_path: str) -> int:
    """One rank of [tp] under `torch.distributed.run --nproc_per_node 2`.
    It starts the process group itself (gloo, both ranks on cuda:0: NCCL
    refuses two ranks on one card), probes it (`tp_probe`; a collective
    gloo does not serve for CUDA tensors fails the phase), and `run_stage`
    takes that group as it is; stage 2 with --tensor_parallel 2 --sequence_parallel true, each
    microbatch counted as in the stages phase, the heads every attention
    call is handed, and after update 1 every parameter that `tensor`
    leaves whole compared between the two ranks (rank 1 against rank 0's,
    broadcast).  Every rank writes its numbers to `<result>.<rank>`."""
    import torch.distributed as dist

    from llavamod_tpu_torch.models.llm import decoder
    from llavamod_tpu_torch.parallel import collectives
    from llavamod_tpu_torch.parallel.sharding import local_tensor
    from llavamod_tpu_torch.train import run, steps

    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    probe = tp_probe()
    if rank == 0:
        print(f"[probe] gloo with CUDA tensors on cuda:0, "
              f"{dist.get_world_size()} ranks: {json.dumps(probe)}",
              flush=True)
    missing = [op for op, r in probe.items() if r != "ok"]
    if missing:
        raise AssertionError(f"[tp] gloo does not serve {missing} for CUDA "
                             f"tensors: {probe}")
    margs, dargs, targs, extra = parse_stage("align", spec["config"],
                                             spec["argv"])
    records, heads, replicas, held = [], set(), {}, {}
    originals = dict(attn=decoder.dot_product_attention)

    def attn(q, k, v, *a, **kw):
        heads.add((int(q.shape[2]), int(k.shape[2])))
        return originals["attn"](q, k, v, *a, **kw)

    @torch.no_grad()
    def compare(model):
        pctx = collectives.current()
        splits = getattr(model, "tensor_split", {})
        same = total = trained = 0
        for n, p in model.named_parameters():
            if n in splits:
                continue
            t = local_tensor(p).detach()
            ref = t.clone()
            dist.broadcast(ref, dist.get_process_group_ranks(
                pctx.tensor_group)[0], group=pctx.tensor_group)
            same += bool(torch.equal(ref, t))
            total += 1
            trained += p.requires_grad
        replicas.update(same=same, total=total, trained=trained,
                        split=len(splits))

    def make(*a, **k):
        step = originals["make"](*a, **k)
        calls = []

        def checked(state, teacher, batch):
            out = step(state, teacher, batch)
            calls.append(1)
            if len(calls) == targs.gradient_accumulation_steps:
                compare(out[0].model)
            held.update(model=out[0].model, pctx=collectives.current())
            return out
        return checked

    torch.cuda.reset_peak_memory_stats()
    decoder.dot_product_attention = attn
    try:
        with counted_steps(records, profile_call=spec.get("profile_call")):
            originals["make"] = steps.make_align_step
            steps.make_align_step = make
            try:
                _reset_launch_counts()
                run.run_stage("align", margs, dargs, targs, salign=extra,
                              tokenizer=StandInTokenizer(), device="cuda")
                launches = _launch_counts()
            finally:
                steps.make_align_step = originals["make"]
    finally:
        decoder.dot_product_attention = originals["attn"]
    peak = max([torch.cuda.max_memory_allocated() / 2**30]
               + [max(r["prior_peak_gib"], r["peak_gib"]) for r in records])
    tp_s = time.perf_counter() - t0
    # the sharded checkpoint's record, then its room on the disk for [pp]
    ckpt = os.path.join(targs.output_dir, f"checkpoint-{STAGE_ACCUM}")
    dist.barrier()
    ckpt_info = None
    remove = threading.Thread(target=shutil.rmtree, args=(ckpt,))
    if rank == 0:
        with open(os.path.join(ckpt, "mesh.json")) as f:
            ckpt_info = dict(files=sorted(os.listdir(ckpt)),
                             gb=dir_bytes(ckpt) / 1e9, mesh=json.load(f))
        remove.start()
    generated = tp_generate_phase(held["model"], held["pctx"])
    held.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        remove.join()
    dist.barrier()
    pp = pp_phase(spec)
    with open(f"{spec['result']}.{rank}", "w") as f:
        json.dump(dict(records=records, launches=launches, peak_gib=peak,
                       heads=sorted(heads), replicas=replicas, rank=rank,
                       probe=probe, worker_s=time.perf_counter() - t0,
                       tp_s=tp_s, ckpt=ckpt_info, generate=generated, pp=pp,
                       world=dist.get_world_size(),
                       backend=dist.get_backend(), torch=torch.__version__),
                  f)
    dist.destroy_process_group()
    return 0


def tp_runs(config: str, argv: list, root: str, dev, card: str) -> dict:
    """[tp], [tp generate] and [pp], before the single-process stage 2 (the
    gloo probe first, in the worker): stage 2 (`argv`: the stages phase's)
    with --tensor_parallel 2 --sequence_parallel true under one
    `torch.distributed.run --standalone --nproc_per_node 2`, both ranks on
    the one card over gloo, a sharded checkpoint after update 1 (written,
    recorded and removed by the worker, not resumed here: the CPU tests
    resume it at tensor=2), microbatch TP_PROFILE_CALL profiled; then in
    the same worker the trained student's greedy generation, stage 2 at
    --pipeline_parallel 2 (PP_FLAGS) and its stages' generation.  Here:
    rank 0's [tp] model.pt through `load_pretrained_model` on the card,
    kept on the host for `tp_check`, and its single-process generation of
    the same batch; rank 0's [pp] model.pt, kept on the host, and its
    single-process generation; the single-process reference of [pp] (the
    same argv without the pipeline, the same gating groups); gloo's
    point-to-point on CUDA tensors probed by a torchrun of its own
    alongside.  The output directories are removed at the end."""
    from llavamod_tpu_torch.models.builder import load_pretrained_model
    from llavamod_tpu_torch.train import run
    from llavamod_tpu_torch.train.args import AlignArgs

    out = os.path.join(root, "out_align_tp")
    out_pp = os.path.join(root, "out_align_pp")
    pp_argv = argv + PP_FLAGS + ["--output_dir", out_pp]
    argv = argv + TP_FLAGS + ["--output_dir", out, "--save_steps",
                              str(STAGE_ACCUM)]
    margs, _, targs, extra = parse_stage("align", config, argv)
    assert isinstance(extra, AlignArgs) and targs.tensor_parallel == TP_RANKS
    layers = _num_layers(extra.policy_model_name_or_path)
    teacher_layers = _num_layers(extra.ref_model_name_or_path)
    per_mb = {"flash_fwd": layers * (2 if targs.remat else 1)
              + teacher_layers, "flash_dq": layers, "flash_dkv": layers}
    spec = dict(config=config, argv=argv, pp_argv=pp_argv,
                profile_call=TP_PROFILE_CALL,
                result=os.path.join(root, "tp_result.json"))
    spec_path = os.path.join(root, "tp_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    probe_proc, probe_path = p2p_probe_start(root)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(TP_RANKS), os.path.abspath(__file__),
         "--tp-worker", spec_path], env=env, cwd=here, capture_output=True,
        text=True, timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    p2p = p2p_probe_result(probe_proc, probe_path)
    log(f"[pp] gloo point-to-point on CUDA tensors (cuda:0, 2 ranks, a "
        f"torchrun of its own): {json.dumps(p2p)}; the pipeline's transport "
        f"under gloo stages through host buffers")
    for line in proc.stdout.splitlines():
        if line.startswith(("[probe]", "[mesh]", "[ckpt]", "[run]", "[data]",
                            "[step")):
            log(f"[tp] | {line}")
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-8000:])
        raise AssertionError(f"[tp]: torchrun exited {proc.returncode}")
    ranks = []
    for r in range(TP_RANKS):
        with open(f"{spec['result']}.{r}") as f:
            ranks.append(json.load(f))
    lines = _read_json_lines(os.path.join(out, "metrics.jsonl"))
    with open(os.path.join(out, "run_info.json")) as f:
        info = json.load(f)
    ckpt = ranks[0]["ckpt"]
    _, model, _, _, _ = load_pretrained_model(out, device=dev,
                                              tokenizer=StandInTokenizer())
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    loaded_on = str(next(model.parameters()).device)
    single_gen = single_generation(model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out)
    pp = dict(ranks=[r.pop("pp") for r in ranks],
              lines=_read_json_lines(os.path.join(out_pp, "metrics.jsonl")),
              p2p=p2p, layers=layers, teacher_layers=teacher_layers,
              remat=targs.remat)
    with open(os.path.join(out_pp, "run_info.json")) as f:
        pp["info"] = json.load(f)
    pp["state"] = torch.load(os.path.join(out_pp, "model.pt"),
                             map_location="cpu", weights_only=True)
    _, model, _, _, _ = load_pretrained_model(out_pp, device=dev,
                                              tokenizer=StandInTokenizer())
    pp["generate"] = dict(ranks=[r.pop("generate") for r in pp["ranks"]],
                          single=single_generation(model, dev),
                          layers=layers)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_pp)
    pp["single"] = pp_reference(config, pp_argv, root)
    generated = dict(ranks=[r.pop("generate") for r in ranks],
                     single=single_gen, layers=layers)
    return dict(ranks=ranks, lines=lines, info=info, state=state,
                loaded_on=loaded_on, ckpt_gb=ckpt["gb"],
                ckpt_mesh=ckpt["mesh"], ckpt_files=ckpt["files"],
                wall_s=wall, per_mb=per_mb, probe=ranks[0]["probe"],
                lr=targs.learning_rate,
                tokens=targs.per_device_train_batch_size
                * targs.model_max_length, pp=pp, generate=generated)


def single_generation(model, dev) -> dict:
    """The single-process generation of `model` (a model.pt loaded on the
    card) for `generate_batch`, its head in the int8 form the stage trained
    with (--policy_head_quant), counted as the sharded runs are."""
    from llavamod_tpu_torch.generation import GenerationConfig
    from llavamod_tpu_torch.models.llm.decoder import quantize_head_int8
    from llavamod_tpu_torch.parallel.collectives import active

    llm = model.llm
    with torch.no_grad():
        head = quantize_head_int8(llm.lm_head.weight)
    del llm.lm_head._parameters["weight"]
    llm.lm_head.weight = head
    with active(None):
        out = counted_generation(
            model, generate_batch(model.cfg, dev),
            GenerationConfig(max_new_tokens=GEN_NEW_TOKENS))
    out["gating_group"] = model.cfg.llm.moe_gating_group_size
    return out


def pp_reference(config: str, pp_argv: list, root: str) -> dict:
    """[pp]'s single-process reference: `run_stage` with [pp]'s argv
    without the pipeline flags (the same rows at B = PP_ROWS, the same
    gating groups, one update), each step counted; its metrics and the
    state dict its final save would write (kept on the host in its place),
    the output removed."""
    from llavamod_tpu_torch.train import run

    out = os.path.join(root, "out_align_pp_single")
    argv = [a for i, a in enumerate(pp_argv)
            if a not in ("--pipeline_parallel", "--pipeline_microbatches")
            and pp_argv[i - 1] not in ("--pipeline_parallel",
                                       "--pipeline_microbatches")]
    margs, dargs, targs, extra = parse_stage(
        "align", config, argv + ["--output_dir", out])
    assert targs.pipeline_parallel == 1
    records, final = [], {}

    def keep_state(output_dir, cfg, state, tcfg, stash, *a, **k):
        # what `final_save` would write, kept on the host
        final.update(run.float_state(
            {k: v.detach().to("cpu", copy=True)
             for k, v in state.model.state_dict().items()}, stash))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    orig_save = run.final_save
    run.final_save = keep_state
    try:
        with sequence_gating(targs.model_max_length), counted_steps(records):
            _reset_launch_counts()
            run.run_stage("align", margs, dargs, targs, salign=extra,
                          tokenizer=StandInTokenizer(), device="cuda")
            launches = _launch_counts()
    finally:
        run.final_save = orig_save
    seconds = time.perf_counter() - t0
    peak = max([torch.cuda.max_memory_allocated() / 2**30]
               + [max(r["prior_peak_gib"], r["peak_gib"]) for r in records])
    res = dict(records=records, launches=launches, peak_gib=peak,
               seconds=seconds,
               lines=_read_json_lines(os.path.join(out, "metrics.jsonl")),
               state=final)
    shutil.rmtree(out)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _upcycled_start(key: str, start: dict, like: torch.Tensor
                    ) -> torch.Tensor:
    """The value `run_stage` upcycled stage 2b's entry `key` from: stage
    2a's FFN matrix (copied into every expert) or a zero router."""
    if key in start:
        return start[key]
    if ".experts." in key:
        return start[key.replace(".experts.", ".")].unsqueeze(0).expand(
            like.shape)
    if key.endswith(".router"):
        return torch.zeros_like(like)
    raise KeyError(key)


def update_agreement(state: dict, ref: dict, start: dict, keys, dev
                     ) -> dict:
    """For each entry in `keys`: its elements that moved from the upcycled
    start in either run, those whose two values lie more than one bf16 ulp
    (of the single-process value) apart, their share, ||u_tp - u|| / ||u||
    of the updates, and the share the same rule gives two planted faults:
    the update negated, and (routers) the entry left at its start."""
    out = {}
    for k in keys:
        s = ref[k].to(dev)
        t = state[k].to(dev)
        x0 = _upcycled_start(k, start, ref[k]).to(dev, s.dtype)
        if x0.shape != s.shape:
            raise AssertionError(f"[tp] {k}: start {tuple(x0.shape)} vs "
                                 f"{tuple(s.shape)}")
        moved = (s != x0) | (t != x0)
        n = int(moved.sum())
        s, t, x0 = s.float(), t.float(), x0.float()
        ulp = _bf16_ulp(s)
        u = s - x0

        def share(tt):
            return int(((tt - s).abs() > ulp).sum()) / max(n, 1)

        d = int(((t - s).abs() > ulp).sum())
        a = dict(moved=n, disagree=d, share=d / max(n, 1),
                 rel=float((t - s).norm() / u.norm().clamp_min(1e-30)),
                 share_negated=share(2 * x0 - t))
        if k.endswith(".router"):
            a["share_router_fault"] = share(x0)
        out[k] = a
        del s, t, x0, ulp, u, moved
    torch.cuda.empty_cache()
    return out


def model_pt_agreement(tag: str, state: dict, ref: dict, start: dict, dev,
                       how: str):
    """Rank 0's model.pt `state` against the single-process output `ref`
    of the same run: frozen llm.* entries bitwise, each trained entry by
    its update from the upcycled `start` (`update_agreement`: the share of
    moved elements more than one bf16 ulp off, TP_UPDATE_DISAGREE_MAX,
    with two planted faults that must exceed it).  Prints the numbers and
    raises on a failed check; returns (the bitwise llm.* keys, the llm.*
    keys, the update summary)."""
    if state.keys() != ref.keys():
        raise AssertionError(f"{tag} model.pt keys differ from the single "
                             "process's")
    llm = [k for k in state if k.startswith("llm.")]
    trained = [k for k in llm if any(m in k.replace(".", "/")
                                     for m in RECORD_TRAIN_SET)]
    same = [k for k in llm if torch.equal(state[k], ref[k])]
    frozen_moved = [k for k in llm if k not in trained and k not in same]
    # the start is stage 2a's output as the stage loaded it (in the
    # stage's dtype): its frozen entries are the single-process output's
    start_frozen = [k for k in llm if k not in trained and k in start
                    and not torch.equal(start[k].to(ref[k].dtype), ref[k])]
    agree = update_agreement(state, ref, start, trained, dev)
    worst = max(agree, key=lambda k: agree[k]["share"])
    upd = dict(moved=sum(a["moved"] for a in agree.values()),
               disagree=sum(a["disagree"] for a in agree.values()),
               max_share=agree[worst]["share"], max_share_entry=worst,
               max_rel=max(a["rel"] for a in agree.values()),
               router_fault_min_share=min(a["share_router_fault"]
                                          for a in agree.values()
                                          if "share_router_fault" in a),
               negated_min_share=min(a["share_negated"]
                                     for a in agree.values()))
    log(f"{tag} rank 0's model.pt {how}: {len(state)} entries; of the "
        f"{len(llm)} llm.* entries {len(same)} bitwise the single-process "
        f"stage 2 output (frozen ones not bitwise: {len(frozen_moved)}; "
        f"frozen ones not stage 2a's: {len(start_frozen)})")
    log(f"{tag} the {len(trained)} trained entries' updates from the "
        f"upcycled start against the single-process run's: "
        f"{upd['disagree']:,} of {upd['moved']:,} moved elements more than "
        f"one bf16 ulp apart; the largest share of an entry "
        f"{upd['max_share']:.3e} ({worst}; limit {TP_UPDATE_DISAGREE_MAX}), "
        f"the largest ||u_tp - u|| / ||u|| {upd['max_rel']:.3e}; planted "
        f"faults, the least share over the entries they touch: routers left "
        f"at the start {upd['router_fault_min_share']:.3f}, updates negated "
        f"{upd['negated_min_share']:.3f}")
    for k in sorted(agree, key=lambda k: -agree[k]["share"])[:4]:
        log(f"{tag}   {k}: {agree[k]['disagree']:,} of "
            f"{agree[k]['moved']:,} moved ({agree[k]['share']:.3e}), rel "
            f"{agree[k]['rel']:.3e}")
    blind = [k for k, a in agree.items()
             if a["share_negated"] <= TP_UPDATE_DISAGREE_MAX
             or a.get("share_router_fault", 1.0) <= TP_UPDATE_DISAGREE_MAX]
    if blind or not all(a["moved"] for a in agree.values()) or start_frozen:
        raise AssertionError(f"{tag} the update check cannot see a fault in "
                             f"{blind[:8]} (start {start_frozen[:8]}): "
                             f"{agree}")
    far = [k for k, a in agree.items()
           if a["share"] > TP_UPDATE_DISAGREE_MAX]
    if far or frozen_moved:
        raise AssertionError(f"{tag} model.pt entries off the single-process "
                             f"output: {far[:8]} {frozen_moved[:8]}")
    return same, llm, upd


def tp_check(raw: dict, single: dict, single_out: str, start_out: str,
             card: str, dev) -> dict:
    """[tp] against the single-process stage 2 of this call (`single`, its
    output in `single_out`, its start stage 2a's output in `start_out`):
    prints the numbers and raises on a failed check."""
    ranks, lines, info, per_mb = (raw["ranks"], raw["lines"], raw["info"],
                                  raw["per_mb"])
    r0 = ranks[0]
    ms = [r["ms"] for r in r0["records"]]
    med = statistics.median(ms[1:])
    sp = single["first"]
    got = {k: v for k, v in lines[0].items()
           if k not in ("step", "sec_per_step")}
    rel = {k: abs(got[k] - sp[k]) / abs(sp[k]) for k in ("loss",
                                                         "grad_norm")}
    log(f"[tp] torch {r0['torch']}, world {r0['world']} on one card, "
        f"backend {r0['backend']}, mesh {info.get('mesh')}; gloo probe "
        f"{raw['probe']}; torchrun {raw['wall_s']:.1f} s (the worker "
        f"{r0['worker_s']:.1f} s: load and build "
        f"{info['build_and_load_s']:.1f} s, loop {info['loop_s']:.1f} s, "
        f"saves {info['save_s']:.1f} s); on {card}")
    log(f"[tp] microbatch ms {' / '.join(f'{t:.1f}' for t in ms)} (median "
        f"after the first {med:.1f}) against {single['median_ms']:.1f} "
        f"single-process ({med / single['median_ms']:.3f}x); "
        f"{raw['tokens'] / med * 1e3:.1f} tokens/s; peak GiB per rank "
        f"{' / '.join(f'{r['peak_gib']:.2f}' for r in ranks)} (both on the "
        f"one card: {sum(r['peak_gib'] for r in ranks):.2f}) against "
        f"{single['peak_gib']:.2f} single-process; on {card}")
    for r in ranks:
        log(f"[tp] rank {r['rank']}: launches per microbatch "
            f"{[x['launches'] for x in r['records']]} (need {per_mb} each); "
            f"attention (query heads, KV heads) seen {r['heads']}; "
            f"device GiB at each microbatch's start "
            f"{' / '.join(f'{x['start_gib']:.2f}' for x in r['records'])}")
    prof = next(x["profile"] for x in r0["records"] if "profile" in x)
    coll = prof["collectives"]
    log(f"[tp] profiled microbatch (rank 0): {prof['wall_ms']:.1f} ms wall, "
        f"{prof['busy_ms']:.1f} ms device busy over {prof['kernels']} "
        f"kernels; the tensor group's collectives staged through the host: "
        f"device copies {coll['copies']['ms']:.3f} ms over "
        f"{coll['copies']['count']}, host ops "
        + ", ".join(f"{k} {v['host_ms']:.1f} ms x{v['count']}"
                    for k, v in coll["ops"].items()) + f"; on {card}")
    for x in prof["top"]:
        log(f"[tp]   {x['ms']:9.3f} ms x{x['count']:<5d} {x['name']}")
    log(f"[tp] first microbatch against the single-process stage 2: loss "
        f"{got['loss']:.7f} vs {sp['loss']:.7f} (rel {rel['loss']:.3e}, tol "
        f"{LOSS_REL_TOL}), grad_norm {got['grad_norm']:.7f} vs "
        f"{sp['grad_norm']:.7f} (rel {rel['grad_norm']:.3e}, tol "
        f"{GRAD_NORM_REL_TOL})")
    reps = [r["replicas"] for r in ranks]
    log(f"[tp] after update 1, parameters that tensor leaves whole equal on "
        f"the two ranks: {reps[1]['same']} of {reps[1]['total']} "
        f"({reps[1]['trained']} of them trained; {reps[1]['split']} "
        f"tensors split); sharded checkpoint after update 1: "
        f"{raw['ckpt_gb']:.2f} GB, files {raw['ckpt_files']}, mesh "
        f"{raw['ckpt_mesh']['mesh']}")
    want_heads = {"student": [16 // TP_RANKS] * 2,
                  "teacher": [32 // TP_RANKS] * 2}
    if not (info.get("mesh") == dict(data=1, fsdp=1, expert=1,
                                     tensor=TP_RANKS, pipe=1)
            and all(r["backend"] == "gloo" and r["world"] == TP_RANKS
                    for r in ranks)):
        raise AssertionError(f"[tp] did not run the tensor mesh: {info}")
    for r in ranks:
        if len(r["records"]) != STAGE_MICROBATCHES or any(
                x["launches"] != per_mb for x in r["records"]):
            raise AssertionError(f"[tp] rank {r['rank']} launches "
                                 f"{r['records']}, need {per_mb}")
        if sorted(r["heads"]) != sorted(map(list, want_heads.values())):
            raise AssertionError(f"[tp] rank {r['rank']} ran heads "
                                 f"{r['heads']}, need {want_heads}")
    if not (rel["loss"] <= LOSS_REL_TOL
            and rel["grad_norm"] <= GRAD_NORM_REL_TOL):
        raise AssertionError(f"[tp] first microbatch disagrees: {rel}")
    if not all(np.isfinite(v) for ln in lines for v in ln.values()) or \
            info["optimizer_updates"] != STAGE_MICROBATCHES // STAGE_ACCUM:
        raise AssertionError(f"[tp] run: {lines} {info}")
    if reps[1]["same"] != reps[1]["total"] or not reps[1]["trained"]:
        raise AssertionError(f"[tp] replicated parameters differ: {reps}")
    if raw["ckpt_mesh"]["mesh"]["tensor"] != TP_RANKS or not {
            f.split("_")[2] for f in raw["ckpt_files"]
            if f.endswith(".distcp")} == {"0", "1"}:
        raise AssertionError(f"[tp] checkpoint {raw['ckpt_files']} "
                             f"{raw['ckpt_mesh']}")

    ref = torch.load(os.path.join(single_out, "model.pt"), map_location="cpu",
                     weights_only=True, mmap=True)
    start = torch.load(os.path.join(start_out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    state = raw["state"]
    same, llm, upd = model_pt_agreement(
        "[tp]", state, ref, start, dev,
        f"through load_pretrained_model on {raw['loaded_on']}")
    del ref, start
    return dict(step_ms=ms, median_ms=med,
                tokens_per_s=raw["tokens"] / med * 1e3,
                single_median_ms=single["median_ms"],
                peak_gib=[r["peak_gib"] for r in ranks],
                launches=r0["launches"], launches_per_microbatch=per_mb,
                heads=r0["heads"], first=got, single_first=sp, rel=rel,
                replicas=reps[1], checkpoint_gb=raw["ckpt_gb"],
                load_s=info["build_and_load_s"], save_s=info["save_s"],
                torchrun_s=raw["wall_s"], profile=prof, probe=raw["probe"],
                model_llm_bitwise=len(same), model_llm_entries=len(llm),
                model_trained_updates=upd)


def pp_check(raw: dict, start_out: str, card: str, dev) -> dict:
    """[pp] against its single-process reference of this call (`raw`'s
    `single`: [pp]'s argv without the pipeline), stage 2a's output in
    `start_out` the upcycled start: prints the numbers and raises on a
    failed check."""
    ranks, single, info, lines = (raw["ranks"], raw["single"], raw["info"],
                                  raw["lines"])
    layers, teacher_layers = raw["layers"], raw["teacher_layers"]
    per_row = {"flash_fwd": layers // PP_RANKS * (2 if raw["remat"] else 1)
               + teacher_layers // PP_RANKS,
               "flash_dq": layers // PP_RANKS,
               "flash_dkv": layers // PP_RANKS}
    per_step = {k: v * PP_MICROBATCHES for k, v in per_row.items()}
    whole_row = {"flash_fwd": layers * (2 if raw["remat"] else 1)
                 + teacher_layers, "flash_dq": layers, "flash_dkv": layers}
    got = {k: v for k, v in lines[0].items()
           if k not in ("step", "sec_per_step")}
    sp = {k: v for k, v in single["lines"][0].items()
          if k not in ("step", "sec_per_step")}
    rel = {k: abs(got[k] - sp[k]) / abs(sp[k]) for k in ("loss",
                                                         "grad_norm")}
    bitwise = all(got[k] == sp[k] for k in sp)
    ms = [[x["ms"] for x in r["records"]] for r in ranks]
    single_ms = [x["ms"] for x in single["records"]]
    log(f"[pp] stage 2b at pipe={PP_RANKS}, {PP_MICROBATCHES} microbatches "
        f"of {PP_ROWS // PP_MICROBATCHES} row (B={PP_ROWS}, T={TRAIN_T}), "
        f"gating groups of one sequence, "
        f"two ranks on the one card over gloo, mesh {info.get('mesh')}; "
        f"stages' layers {[r['stage'].get('layers') for r in ranks]}; on "
        f"{card}")
    log(f"[pp] step ms per rank {[' / '.join(f'{t:.1f}' for t in m) for m in ms]}"
        f" against {' / '.join(f'{t:.1f}' for t in single_ms)} single-process"
        f" (step 2: {ms[0][-1] / single_ms[-1]:.3f}x); peak GiB per rank "
        f"{' / '.join(f'{r['peak_gib']:.2f}' for r in ranks)} (both on the "
        f"one card: {sum(r['peak_gib'] for r in ranks):.2f}) against "
        f"{single['peak_gib']:.2f} single-process; the [pp] phase "
        f"{' / '.join(f'{r['seconds']:.1f}' for r in ranks)} s a rank (load, "
        f"{PP_STEPS} steps, save), the reference {single['seconds']:.1f} s; "
        f"on {card}")
    for r in ranks:
        t, j = r["transport"], r["save_transport"]
        log(f"[pp] rank {r['stage'].get('rank')}: launches per step "
            f"{[x['launches'] for x in r['records']]} (need {per_step}: "
            f"{per_row} a one-row microbatch); transport over the "
            f"{PP_STEPS} steps {t['sends']} sends, {t['recvs']} receives, "
            f"{t['broadcasts']} broadcasts, {t['bytes'] / 1e6:.1f} MB sent, "
            f"{t['host_ms']:.1f} host ms ({t['host_ms'] / PP_STEPS:.1f} a "
            f"step); the final save's join {j['sends']} sends, {j['recvs']}"
            f" receives, {j['bytes'] / 1e6:.1f} MB, {j['host_ms']:.1f} host "
            f"ms")
    log(f"[pp] first step against the single process at B={PP_ROWS}: loss "
        f"{got['loss']:.7f} vs {sp['loss']:.7f} (rel {rel['loss']:.3e}, tol "
        f"{DIST_LOSS_REL_TOL}), grad_norm {got['grad_norm']:.7f} vs "
        f"{sp['grad_norm']:.7f} (rel {rel['grad_norm']:.3e}, tol "
        f"{DIST_GRAD_NORM_REL_TOL}); every metric bitwise: {bitwise}")
    reps = [r["replicas"] for r in ranks]
    log(f"[pp] after update 1, parameters outside the layers equal on the "
        f"two stages: {reps[1]['same']} of {reps[1]['total']} "
        f"({reps[1]['trained']} of them trained)")
    sums = {k: sum(r["records"][0]["launches"][k] for r in ranks)
            / PP_MICROBATCHES for k in per_row}
    if not (info.get("mesh") == dict(data=1, fsdp=1, expert=1, tensor=1,
                                     pipe=PP_RANKS)
            and info["optimizer_updates"] == 1):
        raise AssertionError(f"[pp] did not run the pipeline mesh: {info}")
    for r in ranks:
        if len(r["records"]) != PP_STEPS or any(
                x["launches"] != per_step for x in r["records"]):
            raise AssertionError(f"[pp] rank launches {r['records']}, need "
                                 f"{per_step}")
    if sums != whole_row or single["launches"] != {
            k: v * PP_STEPS for k, v in whole_row.items()}:
        raise AssertionError(f"[pp] the stages' launches {sums} a row, the "
                             f"single process's {single['launches']}")
    if not (rel["loss"] <= DIST_LOSS_REL_TOL
            and rel["grad_norm"] <= DIST_GRAD_NORM_REL_TOL):
        raise AssertionError(f"[pp] first step disagrees: {rel}")
    if not all(np.isfinite(v) for ln in lines for v in ln.values()):
        raise AssertionError(f"[pp] run: {lines}")
    if reps[1]["same"] != reps[1]["total"] or not reps[1]["total"]:
        raise AssertionError(f"[pp] replicated parameters differ: {reps}")
    if not all(r["peak_gib"] < 80 for r in ranks) or \
            sum(r["peak_gib"] for r in ranks) >= 80:
        raise AssertionError(f"[pp] peaks {[r['peak_gib'] for r in ranks]}")
    start = torch.load(os.path.join(start_out, "model.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    same, llm, upd = model_pt_agreement(
        "[pp]", raw["state"], single["state"], start, dev,
        "(its stages' layers joined)")
    del start
    return dict(step_ms=ms, single_step_ms=single_ms,
                peak_gib=[r["peak_gib"] for r in ranks],
                single_peak_gib=single["peak_gib"],
                launches=ranks[0]["launches"], launches_per_step=per_step,
                first=got, single_first=sp, rel=rel, bitwise=bitwise,
                replicas=reps[1], transport=[r["transport"] for r in ranks],
                save_transport=[r["save_transport"] for r in ranks],
                seconds=[r["seconds"] for r in ranks],
                single_seconds=single["seconds"], p2p=raw["p2p"],
                model_llm_bitwise=len(same), model_llm_entries=len(llm),
                model_trained_updates=upd)


def tp_generate_check(raw: dict, card: str) -> dict:
    """[tp generate] against the single-process generation of rank 0's
    model.pt: prints the numbers and raises on a failed check."""
    ranks, single, layers = raw["ranks"], raw["single"], raw["layers"]
    steps = GEN_NEW_TOKENS - 1
    want = dict(prefill={"flash_fwd": layers, "flash_decode": 0},
                decode={"flash_fwd": 0, "flash_decode": layers * steps})
    tokens = np.asarray(single["tokens"])
    for r in ranks + [single]:
        r["per_step_ms"] = sum(d["ms"] for d in r["decode"]) / steps
    for i, r in enumerate(ranks):
        same = np.asarray(r["tokens"]) == tokens
        log(f"[tp generate] rank {i}: {GEN_ROWS} rows x {GEN_NEW_TOKENS} "
            f"greedy tokens, {int(same.sum())} of {same.size} equal to the "
            f"single process's (rows equal: {int(same.all(1).sum())}); "
            f"prefill {r['prefill'][0]['ms']:.1f} ms, K1 "
            f"{r['prefill'][0]['launches']['flash_fwd']}; decode "
            f"{r['per_step_ms']:.2f} ms a step, K2 "
            f"{sum(d['launches']['flash_decode'] for d in r['decode'])} over "
            f"{steps} steps; K2 (query, KV) heads {r['heads']}; on {card}")
    log(f"[tp generate] single process: prefill "
        f"{single['prefill'][0]['ms']:.1f} ms, decode "
        f"{single['per_step_ms']:.2f} ms a step; K2 heads {single['heads']}")
    for r in ranks:
        got = dict(prefill=r["prefill"][0]["launches"], decode={
            k: sum(d["launches"][k] for d in r["decode"])
            for k in ("flash_fwd", "flash_decode")})
        got["prefill"] = {k: got["prefill"][k] for k in want["prefill"]}
        if got != want or r["heads"] != [[16 // TP_RANKS, 16 // TP_RANKS]]:
            raise AssertionError(f"[tp generate] launches {got} heads "
                                 f"{r['heads']}, need {want}")
        if r["tokens"] != single["tokens"]:
            raise AssertionError(f"[tp generate] tokens differ from the "
                                 f"single process's: {r['tokens']} vs "
                                 f"{single['tokens']}")
    return dict(tokens_equal=True, rows=GEN_ROWS, new_tokens=GEN_NEW_TOKENS,
                prefill_ms=[r["prefill"][0]["ms"] for r in ranks],
                decode_ms_per_step=[r["per_step_ms"] for r in ranks],
                single_prefill_ms=single["prefill"][0]["ms"],
                single_decode_ms_per_step=single["per_step_ms"],
                launches=dict(  # rank 0's, measured
                    flash_fwd=ranks[0]["prefill"][0]["launches"]["flash_fwd"],
                    flash_decode=sum(d["launches"]["flash_decode"]
                                     for d in ranks[0]["decode"])),
                heads=ranks[0]["heads"])


def pp_generate_check(raw: dict, card: str) -> dict:
    """[pp generate] against the single-process generation of [pp]'s
    model.pt (its stages' layers joined): prints the numbers and raises on
    a failed check."""
    ranks, single, layers = raw["ranks"], raw["single"], raw["layers"]
    steps = GEN_NEW_TOKENS - 1
    stage_layers = layers // PP_RANKS
    want = dict(prefill={"flash_fwd": stage_layers, "flash_decode": 0},
                decode={"flash_fwd": 0,
                        "flash_decode": stage_layers * steps})
    tokens = np.asarray(single["tokens"])
    for r in ranks + [single]:
        r["per_step_ms"] = sum(d["ms"] for d in r["decode"]) / steps
    for r in ranks:
        same = np.asarray(r["tokens"]) == tokens
        t = {k: sum(d["transport"][k] for d in r["decode"]) / steps
             for k in ("sends", "recvs", "broadcasts", "bytes", "host_ms")}
        p = r["prefill"][0]["transport"]
        log(f"[pp generate] rank {r['stage']} (layers {r['stage'] * stage_layers}"
            f"-{(r['stage'] + 1) * stage_layers - 1}, cache of "
            f"{r['cache_layers']} layers): {GEN_ROWS} rows x "
            f"{GEN_NEW_TOKENS} greedy tokens, {int(same.sum())} of "
            f"{same.size} equal to the single process's; prefill "
            f"{r['prefill'][0]['ms']:.1f} ms, K1 "
            f"{r['prefill'][0]['launches']['flash_fwd']}; decode "
            f"{r['per_step_ms']:.2f} ms a step, K2 "
            f"{sum(d['launches']['flash_decode'] for d in r['decode'])} over "
            f"{steps} steps; peak {r['peak_gib']:.2f} GiB; on {card}")
        log(f"[pp generate] rank {r['stage']} transport: a decode step "
            f"{t['sends']:.0f} sends, {t['recvs']:.0f} receives, "
            f"{t['broadcasts']:.0f} broadcasts, {t['bytes'] / 1e3:.1f} kB "
            f"sent, {t['host_ms']:.2f} host ms; the prefill {p['sends']} "
            f"sends, {p['recvs']} receives, {p['broadcasts']} broadcasts, "
            f"{p['bytes'] / 1e6:.1f} MB sent, {p['host_ms']:.1f} host ms")
    log(f"[pp generate] single process (cache of {single['cache_layers']} "
        f"layers): prefill {single['prefill'][0]['ms']:.1f} ms, decode "
        f"{single['per_step_ms']:.2f} ms a step; the stages against it: "
        f"prefill {ranks[0]['prefill'][0]['ms'] / single['prefill'][0]['ms']:.2f}x,"
        f" decode {ranks[0]['per_step_ms'] / single['per_step_ms']:.2f}x; on "
        f"{card}")
    sampled = [np.asarray(r["sampled"]["tokens"]) for r in ranks]
    log(f"[pp generate] generate_stream at temperature 1, "
        f"{PP_SAMPLE_TOKENS} tokens, the ranks' generators seeded apart: "
        f"the ranks' tokens equal: {bool(np.array_equal(*sampled))}")
    for r in ranks:
        got = dict(prefill=r["prefill"][0]["launches"], decode={
            k: sum(d["launches"][k] for d in r["decode"])
            for k in ("flash_fwd", "flash_decode")})
        got["prefill"] = {k: got["prefill"][k] for k in want["prefill"]}
        if got != want or [list(h) for h in r["heads"]] != [
                list(r["kv_heads"])]:
            raise AssertionError(f"[pp generate] launches {got} heads "
                                 f"{r['heads']}, need {want}")
        if r["cache_layers"] != [stage_layers] or \
                r["sampled"]["cache_layers"] != [stage_layers]:
            raise AssertionError(f"[pp generate] caches of "
                                 f"{r['cache_layers']} layers, need "
                                 f"{stage_layers}")
        if r["gating_group"] != single["gating_group"]:
            raise AssertionError(f"[pp generate] gating groups "
                                 f"{r['gating_group']} vs "
                                 f"{single['gating_group']}")
        if r["tokens"] != single["tokens"]:
            raise AssertionError(f"[pp generate] tokens differ from the "
                                 f"single process's: {r['tokens']} vs "
                                 f"{single['tokens']}")
    if single["cache_layers"] != [layers]:
        raise AssertionError(f"[pp generate] single-process cache of "
                             f"{single['cache_layers']} layers")
    if not (sampled[0].shape == (GEN_ROWS, PP_SAMPLE_TOKENS)
            and np.array_equal(*sampled)
            and ((sampled[0] >= 0) & (sampled[0] < ranks[0]["vocab"])).all()):
        raise AssertionError(f"[pp generate] sampled tokens {sampled}")
    return dict(tokens_equal=True, rows=GEN_ROWS, new_tokens=GEN_NEW_TOKENS,
                prefill_ms=[r["prefill"][0]["ms"] for r in ranks],
                decode_ms_per_step=[r["per_step_ms"] for r in ranks],
                single_prefill_ms=single["prefill"][0]["ms"],
                single_decode_ms_per_step=single["per_step_ms"],
                decode_transport=[{k: sum(d["transport"][k]
                                          for d in r["decode"]) / steps
                                   for k in r["decode"][0]["transport"]}
                                  for r in ranks],
                peak_gib=[r["peak_gib"] for r in ranks],
                cache_layers=[r["cache_layers"] for r in ranks],
                sampled_equal=True, seconds=[r["seconds"] for r in ranks],
                launches=dict(  # rank 0's, measured
                    flash_fwd=ranks[0]["prefill"][0]["launches"]["flash_fwd"],
                    flash_decode=sum(d["launches"]["flash_decode"]
                                     for d in ranks[0]["decode"])),
                heads=ranks[0]["heads"])


def stages_phase(card: str, dev):
    root = tempfile.mkdtemp(prefix="llavamod_stages_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        t0 = time.perf_counter()
        dirs, hf_stats = write_stage_models(root, dev)
        write_s = time.perf_counter() - t0
        data = write_stage_data(root, n_img=576)
        tok = StandInTokenizer()
        outs = {s: os.path.join(root, f"out_{s}") for s, _ in STAGE_CONFIGS}
        outs["align_d2d"] = os.path.join(root, "out_align_d2d")
        common = ["--image_folder", data["images"],
                  "--max_steps", str(STAGE_MICROBATCHES),
                  "--gradient_accumulation_steps", str(STAGE_ACCUM)]
        # the recipes' chain: stage 1 -> 2a (dense -> dense) -> 2b (the
        # upcycled MoE, from 2a's output) -> 3
        argvs = {
            "pretrain": ["--model_name_or_path", dirs["dense"]],
            "align": ["--policy_model_name_or_path", outs["align_d2d"],
                      "--ref_model_name_or_path", dirs["teacher"]],
            "dpo": ["--policy_model_name_or_path", outs["align"],
                    "--ref_model_name_or_path", dirs["teacher"]],
        }
        results = {}
        for stage, config in STAGE_CONFIGS:
            argv = argvs[stage] + common + ["--data_path", data[stage],
                                            "--output_dir", outs[stage]]
            if stage == "align":
                # [dist] first: its checkpoint and the stages' files must fit
                # the disk together; dist_check compares after stage 2
                dist_raw = dist_runs(
                    os.path.join(here, config), argvs["align"] + common
                    + ["--data_path", data["align"]], root, dev, card,
                    dict(fused=argvs["align"] + common + fused_args(data),
                         lora=argvs["align"] + common + [
                             "--data_path", data["align"], "--lora_enable",
                             "True"]))
                more_raw = dist_raw.pop("more")
                log_time("[dist] runs")
                tp_raw = tp_runs(os.path.join(here, config),
                                 argvs["align"] + common
                                 + ["--data_path", data["align"]], root,
                                 dev, card)
                log_time("[tp], [tp generate] and [pp] runs")
            results[stage] = drive_stage(
                stage, os.path.join(here, config), argv, tok, dev, card,
                memory_call=0 if stage == "align" else None)
            log_time(f"stage {stage}")
            if stage == "pretrain":
                check_stage1_outputs(dirs["dense"], outs["pretrain"], dev)
                shutil.rmtree(dirs["dense"])
                results["data"] = data_phase(
                    os.path.join(here, config), data, tok, dev, card,
                    results["pretrain"]["median_ms"])
                log_time("[data]")
                results["align_d2d"] = d2d_stage(
                    dict(JSON_FILE=data["align"], IMAGE_FOLDER=data["images"],
                         REF_MLLM=dirs["teacher"],
                         POLICY_MLLM=outs["pretrain"],
                         OUTPUT_DIR=outs["align_d2d"]),
                    common, outs["pretrain"], tok, dev, card)
                log_time("stage 2a")
                shutil.rmtree(outs["pretrain"])
            if stage == "align":
                log(f"[stages] align: the upcycled stage 2b started from "
                    f"stage 2a's output ({outs['align_d2d']})")
                check_float_head(outs["align_d2d"], outs["align"])
                moe = _moe_config(outs["align"])
                log(f"[stages] align: output config {moe}")
                every_2nd = list(range(0, _num_layers(outs["align"]), 2))
                if not (moe["moe_num_experts"] == 4 and moe["moe_top_k"] == 2
                        and moe["moe_capacity_factor"] == 1.5
                        and moe["moe_layers"] == every_2nd):
                    raise AssertionError(f"stage 2 wrote {moe}")
                results["align_dist"] = dist_check(
                    dist_raw, results["align"], outs["align"], card)
                del dist_raw
                results["generate_tp"] = tp_generate_check(
                    tp_raw.pop("generate"), card)
                results["generate_pp"] = pp_generate_check(
                    tp_raw["pp"].pop("generate"), card)
                results["align_pp"] = pp_check(tp_raw.pop("pp"),
                                               outs["align_d2d"], card, dev)
                results["align_tp"] = tp_check(
                    tp_raw, results["align"], outs["align"],
                    outs["align_d2d"], card, dev)
                del tp_raw
                results["align_fused"] = fused_stage(
                    os.path.join(here, config), argvs["align"] + common,
                    data, root, tok, dev, card, results["align"],
                    more_raw)
                results["align_fused_dist"] = results["align_fused"].pop(
                    "dist")
                log_time("[stages fused]")
                # (removes stage 2a's output once it has rebuilt the base)
                results["align_lora"] = lora_phase(
                    os.path.join(here, config), argvs["align"] + common
                    + ["--data_path", data["align"]], data, root, tok, dev,
                    card, results["align"], more_raw.pop("lora"))
                results["align_lora_dist"] = results["align_lora"].pop("dist")
                del more_raw
                log_time("[lora]")
            if stage == "dpo":
                moe = _moe_config(outs["dpo"])
                if not ("loss/moe_balance" in results["dpo"]["last"]
                        and moe == _moe_config(outs["align"])):
                    raise AssertionError("stage 3 did not train stage 2's "
                                         "MoE student")
                log("[stages] dpo: trained stage 2's MoE student (router aux "
                    "loss logged, MoE config carried to the output)")
                gc.collect()
                torch.cuda.empty_cache()
                results["eval"] = eval_phase(outs["dpo"], data["images"],
                                             root, tok, card)
                log_time("[eval]")
                # the round trip needs the room of the teacher and stage 2
                shutil.rmtree(dirs["teacher"])
                shutil.rmtree(outs["align"])
                results["hf"] = hf_roundtrip_phase(
                    outs["dpo"], data["images"], root, tok, card,
                    results["eval"].pop("bf16_rows"),
                    results["eval"].pop("bf16_first_logits"), dev)
                log_time("[hf]")
                results["hf"]["starts"] = hf_stats
        shutil.rmtree(outs["dpo"])
        results["projectors"] = projectors_phase(data, root, tok, dev, card)
        log_time("[projectors]")
        return dict(results, write_models_s=write_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-worker":
        return tp_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--p2p-probe":
        return p2p_probe_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check needs a GPU",
              file=sys.stderr)
        return 2
    # the port must be importable before anything is printed: a copy of this
    # script without the package prints no result
    from llavamod_tpu_torch import native
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
    native.reset_counts()     # every image batch of the run is counted
    k1 = check_flash_fwd(gen, dev)
    k2 = check_flash_decode(gen, dev)
    k3, k4 = check_flash_bwd(gen, dev)

    int8_gemm = check_int8_gemm(dev)
    log_time("kernels and [int8]")

    t0 = time.perf_counter()
    cfg, model, n_params = build_model(dev)
    torch.cuda.synchronize()
    log(f"[slice] LLaVA-MoD-2B student ({n_params / 1e9:.3f} B params, bf16, "
        f"seeded random weights) built on the card in "
        f"{time.perf_counter() - t0:.1f} s; {activated_line(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    served = serve_phase(cfg, model, card)
    slice_stats = logits_and_timing(cfg, model, served.pop("runner"), card)
    slice_stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[slice] peak device memory {slice_stats['peak_gib']:.2f} GiB")
    served8, slice8 = int8_serving(cfg, model, slice_stats, card)
    log_time("serving")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    trained = train_phase(card, dev)
    log_time("train")
    gc.collect()
    torch.cuda.empty_cache()
    stages = stages_phase(card, dev)
    log_time("stages")

    # outside the [data] phase's PIL pass, every image batch took the C++
    # preprocessor
    pil_pass = stages["data"]["pil"]["prep_batches"]["pil"]
    log(f"[data] image batches of the whole run: {dict(native.counts)}; "
        f"PIL outside the [data] PIL pass: {native.counts['pil'] - pil_pass}")
    if native.counts["pil"] != pil_pass or not native.counts["native"]:
        raise AssertionError(f"image batches took the PIL path outside the "
                             f"[data] PIL pass: {dict(native.counts)}")

    train_n = trained["launches"]
    serve_n = served["launches"]
    stage_n = {path: stages[stage]["launches"] for stage, path in (
        ("pretrain", "pretrain"), ("align", "align_run"), ("dpo", "dpo"),
        ("align_fused", "align_fused"), ("align_d2d", "align_d2d"),
        ("align_dist", "align_dist"), ("align_fused_dist", "align_fused_dist"),
        ("align_lora_dist", "align_lora_dist"))}
    stage_n["align_dist_resumed"] = stages["align_dist"]["resumed_launches"]
    stage_n["align_tp"] = stages["align_tp"]["launches"]     # rank 0's
    stage_n["align_pp"] = stages["align_pp"]["launches"]     # rank 0's
    stage_n["generate_tp"] = stages["generate_tp"]["launches"]  # a rank's
    stage_n["generate_pp"] = stages["generate_pp"]["launches"]  # rank 0's
    stage_n["serve_int8"] = served8["launches"]
    stage_n["train_body_quant"] = trained["body_quant"]["launches"]
    stage_n["train_fused"] = trained["fused"]["launches"]
    stage_n["moe_dispatch"] = trained["dispatch"]["launches"]
    for path, run in (("eval", "bf16"), ("eval_int8", "int8"),
                      ("eval_int8_cache", "int8_cache")):
        stage_n[path] = stages["eval"][run]["launches"]
    stage_n["eval_hf"] = stages["hf"]["eval"]["launches"]
    lora = stages["align_lora"]
    stage_n["align_lora"] = lora["launches"]
    stage_n["eval_lora_adapter"] = lora["eval"]["adapter"]["launches"]
    stage_n["eval_lora_merged"] = lora["eval"]["merged"]["launches"]
    proj = stages["projectors"]
    stage_n["pretrain_s2_qformer"] = proj["s2_qformer"]["launches"]
    stage_n["pretrain_video"] = proj["video"]["launches"]
    stage_n["eval_qformer"] = proj["eval_qformer"]["launches"]

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
             launches_by_path=by_path("flash_decode",
                                      serve=serve_n["flash_decode"]),
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
