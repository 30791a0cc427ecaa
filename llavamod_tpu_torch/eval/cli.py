"""Eval harness CLI: generate -> merge -> convert -> score (port of
llavamod_tpu/eval/cli.py).

One entry point replacing the reference's per-benchmark shell pipelines
(shells/eval/*.sh, e.g. gqa.sh:17-49 fans out chunks, merges jsonl,
converts, scores):

  python -m llavamod_tpu_torch.eval.cli generate --task mmbench \
      --model-path ... --question-file mmbench_dev.tsv \
      --answers-file ans.jsonl --all-rounds
  python -m llavamod_tpu_torch.eval.cli merge --inputs a.jsonl b.jsonl \
      --output m.jsonl
  python -m llavamod_tpu_torch.eval.cli convert --benchmark gqa \
      --answers m.jsonl --output testdev_predictions.json
  python -m llavamod_tpu_torch.eval.cli score --benchmark pope \
      --question-file q.jsonl --answers m.jsonl --annotation-dir coco/

`generate --num-chunks N --chunk-idx K` gives the same chunk fan-out as the
reference's per-GPU deepspeed launches; one process batches on its card,
and fan-out still works across cards and hosts.  `generate` runs on the
card unless `--device` (or `main(..., device=...)`) asks for another;
`main(..., tokenizer=...)` takes a tokenizer object instead of the HF
tokenizer files of the checkpoint directory.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List


def _load_jsonl(path: str) -> List[dict]:
    return [json.loads(l) for l in open(os.path.expanduser(path))]


def _load_json(path: str) -> Any:
    return json.load(open(os.path.expanduser(path)))


def _dump_json(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)
    print(f"wrote {path}")


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def cmd_generate(args) -> None:
    from llavamod_tpu_torch import conversation as conv_lib
    from llavamod_tpu_torch.eval.generate import VQARunner, split_chunk
    from llavamod_tpu_torch.eval.tasks import TASKS
    from llavamod_tpu_torch.generation import GenerationConfig
    from llavamod_tpu_torch.models.builder import load_pretrained_model

    task_kwargs: Dict[str, Any] = {}
    if args.task == "mmbench":
        task_kwargs = dict(all_rounds=args.all_rounds,
                           single_pred_prompt=args.single_pred_prompt,
                           lang=args.lang)
    elif args.task == "sqa":
        task_kwargs = dict(single_pred_prompt=args.single_pred_prompt)
    elif args.task == "mmhal":
        task_kwargs = dict(test_prompt=args.test_prompt)
    elif args.task == "qbench":
        task_kwargs = dict(lang=args.lang)
    questions = TASKS[args.task](args.question_file, **task_kwargs)
    questions = split_chunk(questions, args.num_chunks, args.chunk_idx)

    tokenizer, model, cfg, pp, _ = load_pretrained_model(
        args.model_path, args.model_base, device=args.device,
        tokenizer=args.tokenizer, vision_path=args.vision_path)
    if args.quant == "int8":
        from llavamod_tpu_torch.models.builder import quantize_for_serving

        model = quantize_for_serving(model)
        print("[load] int8-W8A8 serving quantization applied")
    template = args.conv_mode or conv_lib.infer_template_name(args.model_path)
    runner = VQARunner(model, tokenizer, pp, template_name=template,
                       batch_size=args.batch_size,
                       dump_gating=args.dump_gating,
                       model_id=os.path.basename(args.model_path.rstrip("/")))
    eos_ids, stop_seqs = runner.stopping(())
    gcfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_p=args.top_p, eos_token_ids=eos_ids, stop_sequences=stop_seqs,
        pad_token_id=tokenizer.pad_token_id or 0,
        cache_dtype=args.kv_cache_dtype)
    runner.run(questions, args.image_folder, args.answers_file, gcfg)
    print(f"wrote {args.answers_file} ({len(questions)} questions)")
    return runner


# ---------------------------------------------------------------------------
# merge (chunk fan-in, gqa.sh:30-36 cat-loop parity)
# ---------------------------------------------------------------------------

def cmd_merge(args) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as out:
        for path in args.inputs:
            for line in open(os.path.expanduser(path)):
                if line.strip():
                    out.write(line.rstrip("\n") + "\n")
    print(f"wrote {args.output}")


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def cmd_convert(args) -> None:
    from llavamod_tpu_torch.eval import converters

    rows = _load_jsonl(args.answers)
    if args.benchmark == "gqa":
        preds = converters.convert_gqa_for_eval(rows)
        # reference format: list of {questionId, prediction}
        _dump_json([{"questionId": k, "prediction": v}
                    for k, v in preds.items()], args.output)
    elif args.benchmark == "vqav2":
        test_qs = _load_jsonl(args.test_questions)
        _dump_json(converters.convert_vqav2_for_submission(rows, test_qs),
                   args.output)
    elif args.benchmark == "vizwiz":
        test_qs = _load_jsonl(args.test_questions)
        _dump_json(converters.convert_vizwiz_for_submission(rows, test_qs),
                   args.output)
    elif args.benchmark == "seed":
        anns = _load_json(args.annotations)
        if isinstance(anns, dict):
            anns = anns.get("questions", anns)
        _dump_json(converters.convert_seed_for_submission(rows, anns),
                   args.output)
    elif args.benchmark == "mmvet":
        _dump_json(converters.convert_mmvet_for_eval(rows), args.output)
    elif args.benchmark == "mmbench":
        converters.convert_mmbench_for_submission(
            rows, args.test_questions, args.output)
        print(f"wrote {args.output}")
    else:
        raise SystemExit(f"unknown convert benchmark: {args.benchmark}")


# ---------------------------------------------------------------------------
# score
# ---------------------------------------------------------------------------

def cmd_score(args) -> None:
    from llavamod_tpu_torch.eval import scorers

    if args.benchmark == "pope":
        result = scorers.score_pope_dir(args.question_file, args.answers,
                                        args.annotation_dir)
    elif args.benchmark == "sqa":
        problems = _load_json(args.annotations)
        preds = {str(r["question_id"]): r for r in _load_jsonl(args.answers)}
        result = scorers.score_science_qa(problems, preds)
    elif args.benchmark == "textvqa":
        anns = _load_json(args.annotations)
        anns = anns.get("data", anns)
        result = scorers.score_textvqa(anns, _load_jsonl(args.answers))
    elif args.benchmark == "gqa":
        questions = _load_json(args.question_file)
        preds_raw = _load_json(args.answers)
        preds = {p["questionId"]: p["prediction"] for p in preds_raw} \
            if isinstance(preds_raw, list) else preds_raw
        if args.full:
            from llavamod_tpu_torch.eval.gqa_eval import score_gqa_full

            choices = _load_json(args.choices) if args.choices else None
            result = score_gqa_full(questions, preds, choices=choices)
        else:
            result = scorers.score_gqa(questions, preds)
    elif args.benchmark == "mme":
        rows = _load_jsonl(args.answers)
        if args.question_file:  # join answers with question metadata + gt
            rows = scorers.mme_rows_from_answers(
                rows, _load_jsonl(args.question_file))
        result = scorers.score_mme(rows)
    else:
        raise SystemExit(f"unknown score benchmark: {args.benchmark}")

    text = json.dumps(result, indent=2, default=float)
    print(text)
    if args.output:
        _dump_json(result, args.output)


def cmd_baseline(args) -> None:
    """Text-only baseline answers via an LLM API (reference
    qa_baseline_gpt35.py).  Zero-egress default: requires --transport openai
    (needs the openai package + network) or a stub for testing."""
    from llavamod_tpu_torch.eval.gpt_judge import (
        openai_complete_fn,
        qa_baseline,
    )

    questions = _load_jsonl(args.question_file)
    if args.transport == "openai":
        complete = openai_complete_fn(model=args.model,
                                      max_tokens=args.max_tokens)
    elif args.transport == "echo":  # offline smoke transport
        complete = lambda text: f"[echo] {text}"  # noqa: E731
    else:
        raise SystemExit(f"unknown transport: {args.transport}")
    rows = qa_baseline(questions, complete,
                       model_id=f"{args.model}:baseline",
                       max_workers=args.max_workers)
    with open(args.output, "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in rows))


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def build_parser(device: str = "cuda") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.eval")
    sub = ap.add_subparsers(dest="cmd", required=True)

    bl = sub.add_parser("baseline", help="text-only LLM-API baseline answers")
    bl.add_argument("--question-file", required=True)
    bl.add_argument("--output", required=True)
    bl.add_argument("--model", default="gpt-3.5-turbo")
    bl.add_argument("--transport", default="openai",
                    choices=["openai", "echo"])
    bl.add_argument("--max-tokens", type=int, default=1024)
    bl.add_argument("--max-workers", type=int, default=32)
    bl.set_defaults(fn=cmd_baseline)

    g = sub.add_parser("generate", help="answer generation")
    g.add_argument("--task", default="generic",
                   choices=["generic", "mmbench", "sqa", "mmhal", "objhal",
                            "qbench"])
    g.add_argument("--model-path", required=True)
    g.add_argument("--model-base", default=None)
    g.add_argument("--vision-path", default=None,
                   help="an HF CLIP or SigLIP directory: the tower of an HF "
                        "checkpoint directory, which holds none")
    g.add_argument("--question-file", required=True)
    g.add_argument("--image-folder", default="")
    g.add_argument("--answers-file", required=True)
    g.add_argument("--conv-mode", default=None)
    g.add_argument("--num-chunks", type=int, default=1)
    g.add_argument("--chunk-idx", type=int, default=0)
    g.add_argument("--batch-size", type=int, default=8)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--max-new-tokens", type=int, default=128)
    g.add_argument("--all-rounds", action="store_true")
    g.add_argument("--single-pred-prompt", action="store_true", default=True)
    g.add_argument("--lang", default="en")
    g.add_argument("--test-prompt", default="")
    g.add_argument("--dump-gating", default=None,
                   help=".npz router-prob dump (reference "
                        "--return-gating-logit)")
    g.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 = W8A8 serving (attn/MLP/experts/head/embed "
                        "as int8 products; the counterpart of the "
                        "reference's --load-8bit)")
    g.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="KV cache dtype (int8 halves cache HBM+bandwidth)")
    g.add_argument("--device", default=device,
                   help="torch device of the model (default: the card)")
    g.set_defaults(fn=cmd_generate)

    m = sub.add_parser("merge", help="merge chunked answers jsonl")
    m.add_argument("--inputs", nargs="+", required=True)
    m.add_argument("--output", required=True)
    m.set_defaults(fn=cmd_merge)

    c = sub.add_parser("convert", help="submission/eval format conversion")
    c.add_argument("--benchmark", required=True,
                   choices=["gqa", "vqav2", "vizwiz", "seed", "mmvet",
                            "mmbench"])
    c.add_argument("--answers", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--test-questions", default=None)
    c.add_argument("--annotations", default=None)
    c.set_defaults(fn=cmd_convert)

    s = sub.add_parser("score", help="metric scoring")
    s.add_argument("--benchmark", required=True,
                   choices=["pope", "sqa", "textvqa", "gqa", "mme"])
    s.add_argument("--answers", required=True)
    s.add_argument("--question-file", default=None)
    s.add_argument("--annotations", default=None)
    s.add_argument("--annotation-dir", default=None)
    s.add_argument("--full", action="store_true",
                   help="GQA: full official metric suite")
    s.add_argument("--choices", default=None,
                   help="GQA val_choices.json for validity/plausibility")
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_score)
    return ap


def main(argv=None, tokenizer=None, device="cuda"):
    """Run one subcommand; `generate` returns its VQARunner (for callers
    that read its timings), the others None."""
    args = build_parser(device).parse_args(argv)
    args.tokenizer = tokenizer
    return args.fn(args)


if __name__ == "__main__":
    main()
