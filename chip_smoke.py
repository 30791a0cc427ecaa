"""Bring-up check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; exits non-zero without them.  It

  1. builds the hand-written kernels (llavamod_tpu_torch/csrc) from source;
  2. holds each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the serving path gives it, and times both;
  3. builds the LLaVA-MoD-2B student at full width (Qwen1.5-1.8B with 4
     experts top-2 on the even layers, CLIP-ViT-L/336, mlp2x_gelu) from
     seeded random weights directly on the card, serves 8 concurrent image
     requests plus one streamed request through the port's HTTP server, and
     checks that every served prefill went through kernel K1 and every
     decode step through kernel K2;
  4. checks the prefill's last-position logits of the kernel path against
     the same forward with the plain attention, and times prefill and
     decode.

Prints the kernels' JSON line before the last and, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises (exit code 1).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib

import numpy as np
import torch

# tolerances, stated before the run:
#  * kernels vs plain versions in bf16: both accumulate in f32, but the
#    probabilities are rounded to bf16 before P.V against differently
#    normalised running maxima (online vs one-shot softmax), and the output
#    is rounded to bf16 (|out| <~ 4: half an ulp is 1.6e-2);
KERNEL_TOL = 2e-2
#  * full-model prefill logits, kernel path vs plain path: 24 bf16 layers of
#    random weights amplify the kernels' rounding differences; the check is
#    on the max abs difference relative to the logits' max magnitude.
LOGITS_REL_TOL = 5e-2

MAX_BATCH = 8
PROMPT_LEN = 1024
NEW_TOKENS = 32
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of fn() (ms)."""
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


def left_pad_segments(lengths, total: int, dev) -> torch.Tensor:
    seg = torch.zeros((len(lengths), total), dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        seg[i, total - n:] = 1
    return seg


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def check_flash_fwd(gen, dev):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )

    cases = [  # name, B, T, H, KH, D, softcap, valid lengths
        ("serving prefill", 8, PROMPT_LEN, 16, 16, 128, None,
         [1024, 900, 777, 640, 513, 300, 129, 1]),
        ("gqa", 2, 512, 14, 2, 64, None, [512, 200]),
        ("softcap", 2, 256, 16, 16, 128, 50.0, [256, 77]),
    ]
    main = None
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
        err = (o.float() - o_ref.float()).abs()[real].max().item()
        lse_err = (lse - lse_ref).abs().permute(0, 2, 1)[real].max().item()
        pad_zero = bool((o[~real] == 0).all().item()) if (~real).any() else True
        ms = time_ms(lambda: flash_fwd(q, k, v, seg, seg, causal=True,
                                       softcap=cap))
        plain_ms = time_ms(lambda: flash_fwd_reference(
            q, k, v, seg, seg, causal=True, softcap=cap), iters=5)
        log(f"[kernel] flash_fwd {name}: B={b} T={t} H={h} KH={kh} D={d} "
            f"softcap={cap} max_abs_err={err:.3e} lse_err={lse_err:.3e} "
            f"(tol {KERNEL_TOL}) pad_rows_zero={pad_zero} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not (err <= KERNEL_TOL and lse_err <= KERNEL_TOL and pad_zero):
            raise AssertionError(f"flash_fwd {name} disagrees with its plain "
                                 f"version: err {err} lse_err {lse_err} "
                                 f"pad_zero {pad_zero}")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main


def _quant(x):
    amax = x.float().abs().amax(dim=-1)
    s = (amax / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def check_flash_decode(gen, dev):
    from llavamod_tpu_torch.ops.decode_attention import (
        flash_decode,
        flash_decode_reference,
    )

    s_len = PROMPT_LEN + NEW_TOKENS
    cases = [  # name, B, H, KH, D, int8
        ("serving decode bf16", 8, 16, 16, 128, False),
        ("serving decode int8", 8, 16, 16, 128, True),
        ("gqa", 4, 14, 2, 64, False),
    ]
    main = None
    for name, b, h, kh, d, quant in cases:
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
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda: flash_decode(q, k, v, kv_seg=seg, **kw))
        plain_ms = time_ms(lambda: flash_decode_reference(q, k, v, kv_seg=seg,
                                                          **kw))
        log(f"[kernel] flash_decode {name}: B={b} H={h} KH={kh} D={d} "
            f"S={s_len} max_abs_err={err:.3e} (tol {KERNEL_TOL}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"flash_decode {name} disagrees with its "
                                 f"plain version: err {err}")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main


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


def serve_phase(cfg, model, card: str):
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
        log(f"[serve] {MAX_BATCH} concurrent image requests + 1 streamed "
            f"request in {batches} batches: all HTTP 200 with text and usage, "
            f"SSE ends with [DONE]")

        prefills = batches
        steps = batches * (NEW_TOKENS - 1)
        log(f"[serve] launches during the served requests: flash_fwd {fwd_n} "
            f"(need >= {layers} x {prefills} prefills), flash_decode {dec_n} "
            f"(need >= {layers} x {steps} decode steps)")
        if fwd_n < layers * prefills or dec_n < layers * steps or prefills < 2:
            raise AssertionError("the served requests did not go through the "
                                 "kernels on every layer")
        log(f"[serve] 8 concurrent requests: {t_batch:.3f} s, "
            f"{MAX_BATCH / t_batch:.3f} requests/s on {card} "
            f"(includes HTTP, image preprocessing, prefill and "
            f"{NEW_TOKENS} tokens of decode)")
        return dict(launches={"flash_fwd": fwd_n, "flash_decode": dec_n},
                    requests_per_s=MAX_BATCH / t_batch, runner=runner)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def logits_and_timing(cfg, model, runner, card: str):
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
    ok = bool(torch.isfinite(lk).all().item()) and diff <= LOGITS_REL_TOL * scale
    log(f"[slice] prefill last-position logits [{MAX_BATCH}, "
        f"{lk.shape[-1]}], kernel path vs plain attention: max abs diff "
        f"{diff:.4e}, max |logit| {scale:.4e}, rel {diff / scale:.4e} "
        f"(tol {LOGITS_REL_TOL}), greedy argmax agreement {agree:.3f}")
    if not ok:
        raise AssertionError("kernel-path prefill logits disagree with the "
                             "plain-attention forward")

    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)

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
    t_dec = statistics.median(decode_s)
    tok_s = MAX_BATCH * (NEW_TOKENS - 1) / t_dec
    step_ms = sorted(t * 1e3 / (NEW_TOKENS - 1) for t in decode_s)
    log(f"[slice] prefill (B={MAX_BATCH}, T={PROMPT_LEN}, tower + LLM + "
        f"head): {prefill_ms:.3f} ms (median of 5); decode {NEW_TOKENS - 1} "
        f"steps at B={MAX_BATCH}, median of 3: {t_dec * 1e3:.3f} ms, "
        f"{tok_s:.1f} tokens/s, ms/step {step_ms[0]:.3f} / {step_ms[1]:.3f} "
        f"/ {step_ms[2]:.3f} (min / median / max); on {card}")
    return dict(prefill_ms=prefill_ms, decode_tok_s=tok_s, logits_rel=diff / scale)


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
    for line in str(cuda_build.build_info["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        k1 = check_flash_fwd(gen, dev)
        k2 = check_flash_decode(gen, dev)

    t0 = time.perf_counter()
    cfg, model, n_params = build_model(dev)
    torch.cuda.synchronize()
    log(f"[slice] LLaVA-MoD-2B student ({n_params / 1e9:.3f} B params, bf16, "
        f"seeded random weights) built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    served = serve_phase(cfg, model, card)
    slice_stats = logits_and_timing(cfg, model, served["runner"], card)
    log(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_fwd.cu",
             replaces="llavamod_tpu/ops/flash_attention.py:75",
             launches=served["launches"]["flash_fwd"], **k1),
        dict(name="flash_decode", route="cuda",
             source="llavamod_tpu_torch/csrc/flash_decode.cu",
             replaces="llavamod_tpu/ops/decode_attention.py:57",
             launches=served["launches"]["flash_decode"], **k2),
    ]
    log(json.dumps({"slice": slice_stats,
                    "requests_per_s": served["requests_per_s"],
                    "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
