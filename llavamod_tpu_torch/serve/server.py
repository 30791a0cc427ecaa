"""Dynamic-batching HTTP inference server (port of
llavamod_tpu/serve/server.py onto the PyTorch runner and generation).

Same HTTP surface as the JAX package:

  * POST /v1/generate  {"prompt": str, "image": base64-image-or-null,
                        "max_new_tokens": int, "temperature": float,
                        "top_p": float}
      -> {"id", "text", "usage": {"prompt_tokens", "completion_tokens"}}
  * GET  /health       -> {"ok": true, "model": ...}
  * GET  /stats        -> batching counters (requests, batches, histogram)

Requests queue up; a single batcher thread drains up to --max-batch of
them every --batch-window seconds, splits them into one batch per distinct
(temperature, top_p), pads each batch up to a power-of-two bucket, runs the
batched cached decode (llavamod_tpu_torch.generation) on the runner's
device, and fans the texts back out.  Prompt length is padded to
--max-prompt-len, decode length to the largest max_new_tokens in the batch
(each request is trimmed to its own limit host-side); a response ends at
the template's stop string or the tokenizer's EOS (the runner's
`stopping`, as in the JAX package's eval runner).  `--quant int8` serves
the int8 W8A8 form of the model (models/builder.py `quantize_for_serving`).

Spans (runtime/trace.py): `serve.queue` for each request, from its put
into the queue until its batch starts, and `serve.fanout` for each batch,
from `generate`'s return through the replies.

Two differences from the JAX server, whose batcher ignores both: it stops
at the template's stop strings, and it honours each request's
`temperature` and `top_p`.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from llavamod_tpu_torch.runtime import trace


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Request:
    __slots__ = ("prompt", "image", "max_new_tokens", "sampling", "event",
                 "result", "error", "rid", "stream", "chunks", "put_ns")

    def __init__(self, prompt: str, image, max_new_tokens: int,
                 sampling: Tuple[float, float], stream: bool = False):
        self.prompt = prompt
        self.image = image                    # preprocessed array or None
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling              # (temperature, top_p)
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.rid = uuid.uuid4().hex[:16]
        self.stream = stream
        # text deltas for SSE consumers; None = terminal sentinel
        self.chunks: "queue.Queue[Optional[str]]" = queue.Queue()
        self.put_ns = 0                 # trace.stamp() when queued


class BatchingEngine:
    """Queue + batcher thread around a VQARunner encode + generate."""

    def __init__(self, runner, *, max_batch: int = 8,
                 batch_window: float = 0.02, default_max_new: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0,
                 stream_chunk: int = 8):
        from llavamod_tpu_torch.generation import GenerationConfig

        self.runner = runner
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.default_max_new = default_max_new
        self.stream_chunk = stream_chunk
        self._default_sampling = (temperature, top_p)
        self._gcfg_cls = GenerationConfig
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        # written by every submitting thread and the batcher: only under
        # _stats_lock; readers take `stats_snapshot()`
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_rows": 0,
                      "max_batch_seen": 0, "bucket_hist": {}}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batching-engine")
        self._thread.start()

    def stats_snapshot(self) -> Dict[str, Any]:
        """A copy of the counters, taken under the lock."""
        with self._stats_lock:
            return {**self.stats, "bucket_hist": dict(self.stats["bucket_hist"])}

    def _count_request(self) -> None:
        with self._stats_lock:
            self.stats["requests"] += 1

    def _count_batch(self, n: int, bucket: int) -> None:
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_rows"] += n
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n)
            h = self.stats["bucket_hist"]
            h[str(bucket)] = h.get(str(bucket), 0) + 1

    # -- client side ------------------------------------------------------
    def _sampling(self, temperature: Optional[float],
                  top_p: Optional[float]) -> Tuple[float, float]:
        t, p = self._default_sampling
        return (t if temperature is None else float(temperature),
                p if top_p is None else float(top_p))

    def submit(self, prompt: str, image, max_new_tokens: Optional[int],
               timeout: float = 300.0, temperature: Optional[float] = None,
               top_p: Optional[float] = None) -> Dict[str, Any]:
        req = _Request(prompt, image,
                       max_new_tokens or self.default_max_new,
                       self._sampling(temperature, top_p))
        self._count_request()
        req.put_ns = trace.stamp()
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        assert req.result is not None
        return req.result

    def submit_stream(self, prompt: str, image,
                      max_new_tokens: Optional[int],
                      temperature: Optional[float] = None,
                      top_p: Optional[float] = None) -> _Request:
        """Enqueue a STREAMING request and return it immediately; consume
        text deltas from `req.chunks` (None = done, then read req.result /
        req.error)."""
        req = _Request(prompt, image,
                       max_new_tokens or self.default_max_new,
                       self._sampling(temperature, top_p), stream=True)
        self._count_request()
        req.put_ns = trace.stamp()
        self._q.put(req)
        return req

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- batcher side -----------------------------------------------------
    def _drain(self) -> List[_Request]:
        """Block for one request, then collect more within the window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            drained = self._drain()
            groups: Dict[Tuple[float, float], List[_Request]] = {}
            for r in drained:
                groups.setdefault(r.sampling, []).append(r)
            for batch in groups.values():
                self._serve(batch)

    def _serve(self, batch: List[_Request]) -> None:
        try:
            self._run_batch(batch)
        except Exception as exc:  # noqa: BLE001 — fan the error out
            for r in batch:
                r.error = f"{type(exc).__name__}: {exc}"
                r.event.set()
                if r.stream:
                    r.chunks.put(None)

    def _run_batch(self, reqs: List[_Request]):
        from llavamod_tpu_torch.generation import decode_texts, generate

        n = len(reqs)
        bucket = _bucket(n, self.max_batch)
        self._count_batch(n, bucket)
        for r in reqs:      # each request's wait, from its put until now
            trace.record("serve.queue", r.put_ns, id=r.rid)

        prompts = [r.prompt for r in reqs]
        images = [r.image for r in reqs]
        # pad to the bucket with copies of row 0 (batch shapes per bucket,
        # as in the JAX package)
        while len(prompts) < bucket:
            prompts.append(prompts[0])
            images.append(images[0])
        enc = self.runner._encode_batch(prompts, images)
        max_new = max(r.max_new_tokens for r in reqs)
        eos_ids, stop_seqs = self.runner.stopping()
        temperature, top_p = reqs[0].sampling     # one per batch (_loop)
        gcfg = self._gcfg_cls(
            max_new_tokens=max_new,
            pad_token_id=self.runner.tokenizer.pad_token_id or 0,
            eos_token_ids=eos_ids, stop_sequences=stop_seqs,
            temperature=temperature, top_p=top_p)
        import numpy as np

        if any(r.stream for r in reqs):
            # chunked streamed decode: text deltas fan out per request as
            # each chunk lands; concatenated chunks == generate()
            from llavamod_tpu_torch.generation import (
                generate_stream,
                truncate_at_stops,
            )

            acc = None
            prev = ["" for _ in reqs]
            for toks in generate_stream(self.runner.model, enc, gcfg,
                                        chunk=self.stream_chunk):
                acc = toks if acc is None else np.concatenate([acc, toks], 1)
                part = truncate_at_stops(acc, gcfg)
                for i, r in enumerate(reqs):
                    if not r.stream:
                        continue
                    text = decode_texts(
                        self.runner.tokenizer,
                        part[i:i + 1, :r.max_new_tokens],
                        pad_token_id=gcfg.pad_token_id)[0]
                    if len(text) > len(prev[i]):
                        r.chunks.put(text[len(prev[i]):])
                        prev[i] = text
            gen_ids = truncate_at_stops(acc, gcfg)
            if gen_ids.shape[1] < max_new:  # early stop: pad to budget
                pad = np.full((gen_ids.shape[0], max_new - gen_ids.shape[1]),
                              gcfg.pad_token_id, gen_ids.dtype)
                gen_ids = np.concatenate([gen_ids, pad], 1)
        else:
            gen_ids = generate(self.runner.model, enc, gcfg)
        with trace.span("serve.fanout"):
            texts = decode_texts(self.runner.tokenizer, gen_ids,
                                 pad_token_id=gcfg.pad_token_id)
            ids_np = np.asarray(gen_ids)
            for i, r in enumerate(reqs):
                # trim to the REQUEST's own budget (batch decoded to the max)
                own = ids_np[i, :r.max_new_tokens]
                n_out = int((own != gcfg.pad_token_id).sum())
                text = (texts[i] if r.max_new_tokens >= max_new else
                        decode_texts(self.runner.tokenizer, own[None],
                                     pad_token_id=gcfg.pad_token_id)[0])
                r.result = {
                    "id": r.rid,
                    "text": text.strip(),
                    "usage": {
                        "prompt_tokens": int(
                            enc.segment_ids[i].sum()),
                        "completion_tokens": n_out,
                    },
                }
                r.event.set()
                if r.stream:
                    r.chunks.put(None)  # terminal sentinel, after result


def build_engine(model_path: str, *, device: str = "cuda",
                 conv_mode: str = "qwen", quant: str = "",
                 max_batch: int = 8, batch_window: float = 0.02,
                 max_prompt_len: int = 1024, temperature: float = 0.0,
                 default_max_new: int = 128,
                 vision_path: Optional[str] = None) -> BatchingEngine:
    """A BatchingEngine over the checkpoint at `model_path` (native, or an
    HF directory with its tower from `vision_path`); quant='int8' serves
    its int8 W8A8 form."""
    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.models.builder import (
        load_pretrained_model,
        quantize_for_serving,
    )

    if quant not in ("", "int8"):
        raise ValueError(f"quant must be '' or 'int8', got {quant!r}")
    tokenizer, model, cfg, preproc, _ = load_pretrained_model(
        model_path, device=device, vision_path=vision_path)
    if quant == "int8":
        model = quantize_for_serving(model)
    runner = VQARunner(model=model, tokenizer=tokenizer,
                       image_preprocessor=preproc,
                       template_name=conv_mode,
                       max_prompt_len=max_prompt_len)
    return BatchingEngine(runner, max_batch=max_batch,
                          batch_window=batch_window,
                          default_max_new=default_max_new,
                          temperature=temperature)


def make_handler(engine: BatchingEngine, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"ok": True, "model": model_name})
            if self.path == "/stats":
                return self._json(200, engine.stats_snapshot())
            return self._json(404, {"error": "not found"})

        def _stream(self, full_prompt, img, max_new, sampling):
            """Server-sent events: data: {"delta": ...} per text chunk,
            then data: {"done": true, ...final result...}, then [DONE]."""
            req = engine.submit_stream(full_prompt, img, max_new, **sampling)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(obj):
                self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                self.wfile.flush()

            while True:
                item = req.chunks.get(timeout=600)
                if item is None:
                    break
                emit({"delta": item})
            if req.error:
                emit({"error": req.error})
            else:
                emit({"done": True, **req.result})
            self.wfile.write(b"data: [DONE]\n\n")

        def do_POST(self):
            if self.path not in ("/v1/generate", "/generate"):
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                prompt = payload["prompt"]
                img = None
                if payload.get("image"):
                    from PIL import Image

                    raw = base64.b64decode(payload["image"])
                    pil = Image.open(io.BytesIO(raw)).convert("RGB")
                    img = engine.runner.image_preprocessor(pil)
                full = engine.runner.build_prompt(prompt, img is not None)
                sampling = {k: payload.get(k)
                            for k in ("temperature", "top_p")}
                if payload.get("stream"):
                    return self._stream(full, img,
                                        payload.get("max_new_tokens"),
                                        sampling)
                out = engine.submit(full, img,
                                    payload.get("max_new_tokens"),
                                    **sampling)
                return self._json(200, out)
            except (KeyError, ValueError, json.JSONDecodeError) as exc:
                return self._json(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001
                return self._json(500, {"error": str(exc)})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dynamic-batching inference server")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--vision-path", default=None,
                    help="an HF CLIP or SigLIP directory: the tower of an HF "
                         "checkpoint directory, which holds none")
    ap.add_argument("--conv-mode", default="qwen")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window", type=float, default=0.02,
                    help="seconds to wait collecting a batch")
    ap.add_argument("--max-prompt-len", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="int8-W8A8 serving quantization")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = build_engine(
        args.model_path, device=args.device, conv_mode=args.conv_mode,
        quant=args.quant,
        max_batch=args.max_batch, batch_window=args.batch_window,
        max_prompt_len=args.max_prompt_len, temperature=args.temperature,
        default_max_new=args.max_new_tokens, vision_path=args.vision_path)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(engine, args.model_path))
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"(max_batch={args.max_batch}, window={args.batch_window}s)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
