"""Batched eval answer generation (port of llavamod_tpu/eval/generate.py).

Loads a model once, batches questions, runs the KV-cache decode loop
(llavamod_tpu_torch/generation.py: prefill through kernel K1, one K2
launch per layer and decode step on the card), and writes the same
answers-jsonl schema (question_id / prompt / text / answer_id / model_id /
metadata) the scorers and converters consume.

Chunked fan-out parity: --num-chunks/--chunk-idx splits the question list
exactly like split_list/get_chunk (model_vqa_loader.py:20-28).

The MoE router-probability dump (--dump-gating) runs the model forward in
eval mode once more per batch and saves the router probabilities of the
prompt tokens, [moe_layers, T, E] f32 per question id, as .npz.

`VQARunner` also serves the batching server (serve/server.py) and the chat
CLI (serve/cli.py): `build_prompt`, `_encode_batch` and `stopping`.  The
host modules it uses (conversation, mm_utils, data.splice) are the port's
own copies.  `timings` accumulates the host time a batch spends being built
(image load and preprocessing; tokenization, splice and copy to the
device) for callers that report it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from llavamod_tpu_torch import conversation as conv_lib
from llavamod_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from llavamod_tpu_torch.data.splice import expand_image_tokens
from llavamod_tpu_torch.generation import (
    GenerationConfig,
    _no_grad,
    decode_texts,
    generate,
)
from llavamod_tpu_torch.mm_utils import ImagePreprocessor, tokenize_with_images
from llavamod_tpu_torch.models import llava
from llavamod_tpu_torch.models.llava import Llava, LlavaConfig, MultimodalBatch
from llavamod_tpu_torch.parallel.pipeline import pipe_size
from llavamod_tpu_torch.parallel.sharding import gathered


def split_chunk(items: Sequence, num_chunks: int, chunk_idx: int) -> List:
    """Contiguous chunking, parity with split_list/get_chunk
    (model_vqa_loader.py:20-28): ceil-sized chunks, last may be short."""
    size = math.ceil(len(items) / num_chunks)
    chunks = [list(items[i:i + size]) for i in range(0, len(items), size)]
    while len(chunks) < num_chunks:
        chunks.append([])
    return chunks[chunk_idx]


@dataclasses.dataclass
class VQARunner:
    model: Llava
    tokenizer: Any
    image_preprocessor: ImagePreprocessor
    template_name: str = "qwen"
    batch_size: int = 8
    max_prompt_len: int = 1024
    model_id: str = "llavamod-tpu"
    extra_prompt: str = ""           # e.g. SQA's answer-format suffix
    dump_gating: Optional[str] = None  # .npz path for router-prob dumps
    # host seconds spent building batches: 'image' (load + preprocess) and
    # 'encode' (tokenize, splice, copy to the device), summed over calls
    timings: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"image": 0.0, "encode": 0.0})

    @property
    def cfg(self) -> LlavaConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.llm.final_norm.weight.device

    def build_prompt(self, question_text: str, has_image: bool) -> str:
        conv = conv_lib.get_template(self.template_name)
        q = question_text
        if has_image and DEFAULT_IMAGE_TOKEN not in q:
            q = DEFAULT_IMAGE_TOKEN + "\n" + q
        if self.extra_prompt:
            q = q + self.extra_prompt
        conv.append(conv.roles[0], q)
        conv.append(conv.roles[1], None)
        return conv.render()

    def _encode_batch(self, prompts: List[str],
                      images: List[Optional[np.ndarray]]) -> MultimodalBatch:
        t0 = time.perf_counter()
        cfg = self.cfg
        n_tok = cfg.num_image_tokens
        spliced = [
            expand_image_tokens(
                tokenize_with_images(p, self.tokenizer), None,
                num_image_tokens=n_tok, max_len=self.max_prompt_len,
                max_images=cfg.max_images, pad_side="left")
            for p in prompts
        ]
        b = len(prompts)
        s = cfg.vision.image_size
        pixels = np.zeros((b, cfg.max_images, 3, s, s), np.float32)
        valid = np.zeros((b, cfg.max_images), bool)
        for i, img in enumerate(images):
            if img is not None:
                m = min(img.shape[0], cfg.max_images)
                pixels[i, :m] = img[:m]
                valid[i, :m] = True
        image_pos = (np.stack([sp.image_slot for sp in spliced])
                     + (np.arange(b) * cfg.max_images * n_tok)[:, None])
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        ids = np.stack([sp.input_ids for sp in spliced])
        batch = MultimodalBatch(
            input_ids=t(ids, torch.int32),
            segment_ids=t(np.stack([sp.segment for sp in spliced]), torch.int32),
            image_mask=t(np.stack([sp.image_mask for sp in spliced]), torch.bool),
            image_pos=t(image_pos, torch.int32),
            pixels=t(pixels, torch.float32),
            pixel_valid=t(valid, torch.bool),
            labels=t(np.zeros_like(ids), torch.int32))
        self.timings["encode"] += time.perf_counter() - t0
        return batch

    def _load_image(self, q: dict, image_folder: str):
        """(has_image, preprocessed [M, 3, S, S] array or None)."""
        pil = q.get("_pil_image")  # task adapters (base64 benchmarks)
        has_image = pil is not None or ("image" in q and q["image"])
        if pil is not None:
            return has_image, self.image_preprocessor(pil)
        if not has_image:
            return has_image, None
        path = os.path.join(image_folder, q["image"])
        try:
            img = Image.open(path).convert("RGB")
            return has_image, self.image_preprocessor(img)
        except (IOError, OSError) as exc:
            print(f"image load failed for {path}: {exc}")
            return has_image, self.image_preprocessor(
                Image.new("RGB", (224, 224), (0, 0, 0)))

    def answer_batch(self, questions: List[dict], image_folder: str,
                     gcfg: GenerationConfig) -> List[dict]:
        prompts, images, metas = [], [], []
        for q in questions:
            t0 = time.perf_counter()
            has_image, img_arr = self._load_image(q, image_folder)
            self.timings["image"] += time.perf_counter() - t0
            text = q.get("text") or q.get("question")
            prompts.append(self.build_prompt(text, has_image))
            images.append(img_arr)
            metas.append(q)

        batch = self._encode_batch(prompts, images)
        gen_ids = generate(self.model, batch, gcfg)
        if self.dump_gating is not None and self.cfg.llm.is_moe:
            self._collect_gating(batch, metas)
        texts = decode_texts(self.tokenizer, gen_ids,
                             pad_token_id=gcfg.pad_token_id)
        rows = []
        for q, text in zip(metas, texts):
            row = {
                "question_id": q.get("question_id", q.get("id")),
                "prompt": q.get("text") or q.get("question"),
                "text": text.strip(),
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": self.model_id,
                "metadata": {},
            }
            row.update(q.get("_extra", {}))  # e.g. MMBench round_id/options
            rows.append(row)
        return rows

    def run(self, questions: List[dict], image_folder: str,
            answers_file: str, gcfg: Optional[GenerationConfig] = None,
            eos_strings: Sequence[str] = ()) -> List[dict]:
        if gcfg is None:
            eos_ids, stop_seqs = self.stopping(eos_strings)
            gcfg = GenerationConfig(
                max_new_tokens=128,
                eos_token_ids=eos_ids, stop_sequences=stop_seqs,
                pad_token_id=self.tokenizer.pad_token_id or 0)
        os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
        all_rows = []
        with open(answers_file, "w") as f:
            for i in range(0, len(questions), self.batch_size):
                chunk = questions[i:i + self.batch_size]
                # pad the tail with the last question, as the JAX runner does:
                # MoE capacity dispatch depends on the whole batch, so the
                # padded rows keep the answers equal to the reference's
                padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                rows = self.answer_batch(padded, image_folder, gcfg)[:len(chunk)]
                for row in rows:
                    f.write(json.dumps(row) + "\n")
                f.flush()
                all_rows.extend(rows)
        self._save_gating()
        return all_rows

    def _collect_gating(self, batch: MultimodalBatch, metas: List[dict]):
        """Stash per-MoE-layer router probabilities for the prompt tokens:
        one eval-mode forward of the batch (K1 on the card), saved as .npz
        at the end of run().  A model that parallel/sharding.py sharded runs
        it as `generate` does (its module call, under no_grad); under pipe
        > 1 with `scan_layers` off, the stages in turn (the pipelined loop
        returns no router probes), so that every rank holds the probes of
        every MoE layer."""
        cfg = self.cfg
        if pipe_size() > 1:
            cfg = cfg.replace(llm=cfg.llm.replace(scan_layers=False))
        with _no_grad(self.model), gathered(self.model):
            out = self.model(batch, cfg, train=False)
        if not hasattr(self, "_gating_rows"):
            self._gating_rows = {}
        probs = torch.stack([p.float() for p in out.router_probs])  # [L,S,E]
        probs = probs.cpu().numpy()
        b = batch.input_ids.shape[0]
        per_seq = probs.reshape(probs.shape[0], b, -1, probs.shape[-1])
        for i, q in enumerate(metas):
            qid = q.get("question_id", q.get("id"))
            self._gating_rows[str(qid)] = per_seq[:, i]

    def _save_gating(self):
        if self.dump_gating and getattr(self, "_gating_rows", None):
            os.makedirs(os.path.dirname(os.path.abspath(self.dump_gating)),
                        exist_ok=True)
            np.savez_compressed(self.dump_gating, **self._gating_rows)
            print(f"wrote router-prob dump {self.dump_gating} "
                  f"({len(self._gating_rows)} questions)")

    def stopping(self, eos_strings: Sequence[str] = ()):
        """(eos_token_ids, stop_sequences): the template's stop string plus
        any extras; multi-token strings become stop sequences
        (KeywordsStoppingCriteria parity, reference mm_utils.py:74-105)."""
        ids = []
        seqs = []
        if getattr(self.tokenizer, "eos_token_id", None) is not None:
            ids.append(self.tokenizer.eos_token_id)
        conv = conv_lib.get_template(self.template_name)
        for s in list(eos_strings) + [conv.stop_str()]:
            if not s:
                continue
            toks = list(self.tokenizer(s).input_ids)
            if len(toks) == 1:
                ids.append(toks[0])
            elif toks:
                seqs.append(tuple(toks))
        return tuple(dict.fromkeys(ids)), tuple(dict.fromkeys(seqs))


def load_questions(path: str) -> List[dict]:
    if path.endswith(".jsonl"):
        return [json.loads(l) for l in open(path)]
    return json.load(open(path))


def main(argv=None, tokenizer=None, device="cuda"):
    import argparse

    from llavamod_tpu_torch.models.builder import load_pretrained_model

    ap = argparse.ArgumentParser(description="batched VQA answer generation")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--vision-path", default=None,
                    help="an HF CLIP or SigLIP directory: the tower of an HF "
                         "checkpoint directory, which holds none")
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--extra-prompt", default="")
    ap.add_argument("--dump-gating", default=None,
                    help=".npz path for MoE router-prob dumps "
                         "(reference --return-gating-logit)")
    ap.add_argument("--device", default=device,
                    help="torch device of the model (default: the card)")
    args = ap.parse_args(argv)

    tokenizer, model, cfg, pp, _ = load_pretrained_model(
        args.model_path, args.model_base, device=args.device,
        tokenizer=tokenizer, vision_path=args.vision_path)
    template = args.conv_mode or conv_lib.infer_template_name(args.model_path)
    questions = split_chunk(load_questions(args.question_file),
                            args.num_chunks, args.chunk_idx)
    runner = VQARunner(model, tokenizer, pp, template_name=template,
                       batch_size=args.batch_size,
                       extra_prompt=args.extra_prompt,
                       dump_gating=args.dump_gating,
                       model_id=os.path.basename(args.model_path.rstrip("/")))
    eos_ids, stop_seqs = runner.stopping(())
    gcfg = GenerationConfig(max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature, top_p=args.top_p,
                            eos_token_ids=eos_ids, stop_sequences=stop_seqs,
                            pad_token_id=tokenizer.pad_token_id or 0)
    return runner.run(questions, args.image_folder, args.answers_file, gcfg)


if __name__ == "__main__":
    main()
