"""Single-query programmatic inference API (port of
llavamod_tpu/eval/run_llava.py).

Mirror of the reference's `eval/run_llava.py:eval_model` (157 LoC): load a
model once, answer one (image, question) pair — the minimal embedding-friendly
entry point.  The model goes to the card unless `device` asks for another;
`tokenizer` takes a tokenizer object instead of the checkpoint's HF files.

    from llavamod_tpu_torch.eval.run_llava import single_query
    text = single_query("ckpt/stage3", "cat.png", "What is in the image?")

CLI:
    python -m llavamod_tpu_torch.eval.run_llava --model-path ckpt \
        --image-file x.png --query "What is this?"
"""

from __future__ import annotations

import argparse
from typing import Optional


def load_runner(model_path: str, model_base: Optional[str] = None,
                conv_mode: Optional[str] = None, batch_size: int = 1,
                tokenizer=None, device="cuda",
                vision_path: Optional[str] = None):
    from llavamod_tpu_torch import conversation as conv_lib
    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.models.builder import load_pretrained_model

    tokenizer, model, cfg, pp, _ = load_pretrained_model(
        model_path, model_base, device=device, tokenizer=tokenizer,
        vision_path=vision_path)
    template = conv_mode or conv_lib.infer_template_name(model_path)
    return VQARunner(model, tokenizer, pp, template_name=template,
                     batch_size=batch_size)


def single_query(model_path: str, image_file: Optional[str], query: str,
                 *, model_base: Optional[str] = None,
                 conv_mode: Optional[str] = None,
                 temperature: float = 0.0, max_new_tokens: int = 512,
                 runner=None, tokenizer=None, device="cuda",
                 vision_path: Optional[str] = None) -> str:
    """Answer one question about one (optional) image; returns the text.
    Pass a preloaded `runner` (from load_runner) to amortize model loading."""
    import os

    from llavamod_tpu_torch.generation import GenerationConfig

    runner = runner or load_runner(model_path, model_base, conv_mode,
                                   tokenizer=tokenizer, device=device,
                                   vision_path=vision_path)
    eos_ids, stop_seqs = runner.stopping(())
    gcfg = GenerationConfig(
        max_new_tokens=max_new_tokens, temperature=temperature,
        eos_token_ids=eos_ids, stop_sequences=stop_seqs,
        pad_token_id=getattr(runner.tokenizer, "pad_token_id", 0) or 0)
    question = {"question_id": 0, "text": query}
    folder = ""
    if image_file:
        folder, name = os.path.split(os.path.abspath(image_file))
        question["image"] = name
    rows = runner.answer_batch([question] * runner.batch_size, folder, gcfg)
    return rows[0]["text"]


def main(argv=None, tokenizer=None, device="cuda") -> None:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.eval.run_llava")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--vision-path", default=None,
                    help="an HF CLIP or SigLIP directory: the tower of an HF "
                         "checkpoint directory, which holds none")
    ap.add_argument("--image-file", default=None)
    ap.add_argument("--query", required=True)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--device", default=device,
                    help="torch device of the model (default: the card)")
    args = ap.parse_args(argv)
    print(single_query(args.model_path, args.image_file, args.query,
                       model_base=args.model_base, conv_mode=args.conv_mode,
                       temperature=args.temperature,
                       max_new_tokens=args.max_new_tokens,
                       tokenizer=tokenizer, device=args.device,
                       vision_path=args.vision_path))


if __name__ == "__main__":
    main()
