"""Build the review-webpage data.json from question/answer/review files.

Functional port of the reference's
eval/generate_webpage_data_from_table.py:1-111 with its hardcoded
vicuna-vs-ours table paths generalized to a CLI: any number of baseline
models, one "ours" answers file, and one review file per baseline.  The
output schema is the reference webpage's contract
({"questions": [...], "models": [...]}, script.js:70-121): each record
carries the question, every model's answer, the judge's commentary
(cleaned the same way: a leading "<n>, <m>" score line is trimmed and the
Assistant mentions are bolded — reference lines 77-88), and the
[score1, score2] pair.

Usage:
  python -m llavamod_tpu_torch.eval.webpage_data \
      --questions table/question.jsonl \
      --answers vicuna=table/answer/answer_vicuna-13b.jsonl \
      --ours table/results/ours.jsonl \
      --reviews vicuna=table/review/review_vicuna_ours.jsonl \
      --output eval/webpage/data.json

The reference script also applied a hardcoded id-rotation ("Reorder the
records, this is optional", lines 93-105) specific to its 80-question
vicuna table; that cosmetic shuffle is intentionally NOT reproduced —
records sort by question id.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List


def read_jsonl(path: str, key: str = None):
    """reference generate_webpage_data_from_table.py:10-20."""
    data = []
    with open(os.path.expanduser(path)) as f:
        for line in f:
            if not line.strip():
                continue
            data.append(json.loads(line))
    if key is not None:
        data.sort(key=lambda x: x[key])
        data = {item[key]: item for item in data}
    return data


def clean_review(text: str) -> str:
    """Trim a leading 'n, m' score line; bold the Assistant mentions
    (reference lines 77-88)."""
    lines = text.strip().split("\n")
    if lines and re.match(r"\d+[, ]+\d+", lines[0]):
        lines = lines[1:]
    out = "\n".join(lines)
    return (out.replace("Assistant 1", "**Assistant 1**")
               .replace("Assistant 2", "**Assistant 2**"))


def build_records(questions: Dict, ours: Dict, answers: Dict[str, Dict],
                  reviews: Dict[str, Dict]) -> List[dict]:
    records = []
    for qid in questions:
        rec = {
            "id": qid,
            "category": questions[qid].get("category", ""),
            "question": questions[qid].get("text",
                                           questions[qid].get("question", "")),
            "answers": {"ours": ours[qid]["text"]},
            "evaluations": {},
            "scores": {},
        }
        for model, ans in answers.items():
            rec["answers"][model] = ans[qid]["text"]
        for model, rev in reviews.items():
            row = rev[qid]
            rec["evaluations"][model] = clean_review(
                row.get("content", row.get("text", "")))
            rec["scores"][model] = row.get("tuple", row.get("score"))
        records.append(rec)
    records.sort(key=lambda r: r["id"])
    return records


def _kv(pairs: List[str]) -> Dict[str, str]:
    out = {}
    for p in pairs or []:
        name, _, path = p.partition("=")
        if not path:
            raise SystemExit(f"expected NAME=PATH, got {p!r}")
        out[name] = path
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--questions", required=True,
                    help="question.jsonl (question_id/text/category)")
    ap.add_argument("--ours", required=True,
                    help="our model's answers .jsonl")
    ap.add_argument("--answers", nargs="*", default=[], metavar="NAME=PATH",
                    help="baseline answers files")
    ap.add_argument("--reviews", nargs="*", default=[], metavar="NAME=PATH",
                    help="per-baseline review .jsonl "
                         "(gpt_judge.review_answers output)")
    ap.add_argument("--output", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "webpage", "data.json"))
    args = ap.parse_args(argv)

    questions = read_jsonl(args.questions, key="question_id")
    ours = read_jsonl(args.ours, key="question_id")
    answers = {m: read_jsonl(p, key="question_id")
               for m, p in _kv(args.answers).items()}
    reviews = {m: read_jsonl(p, key="question_id")
               for m, p in _kv(args.reviews).items()}

    records = build_records(questions, ours, answers, reviews)
    models = sorted(answers)
    with open(args.output, "w") as f:
        json.dump({"questions": records, "models": models}, f, indent=2)
    print(f"wrote {len(records)} records for models {models + ['ours']} "
          f"-> {args.output}")


if __name__ == "__main__":
    main()
