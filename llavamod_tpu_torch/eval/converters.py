"""Benchmark submission/eval format converters.

Pure-python ports of the reference's scripts/convert_* semantics
(SURVEY.md §2.14): each takes parsed rows and returns the converted rows,
with thin file CLIs in eval/cli.py.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence


def convert_gqa_for_eval(rows: Sequence[dict]) -> Dict[str, str]:
    """answers-jsonl -> {question_id: lowercased answer} dict the GQA scorer
    eats (scripts/convert_gqa_for_eval.py:11-18 writes this as a json list of
    {questionId, prediction})."""
    return {str(r["question_id"]): r["text"].rstrip(".").lower().strip()
            for r in rows}


def convert_vqav2_for_submission(rows: Sequence[dict],
                                 test_questions: Sequence[dict]) -> List[dict]:
    """-> [{'question_id', 'answer'}] covering every test question; missing
    predictions get empty answers (convert_vqav2_for_submission.py)."""
    by_qid = {r["question_id"]: r["text"] for r in rows}

    def clean(ans: str) -> str:
        ans = ans.replace("\n", " ").replace("\t", " ").strip()
        if ans.endswith("."):
            ans = ans[:-1]
        return ans

    return [{"question_id": q["question_id"],
             "answer": clean(by_qid.get(q["question_id"], ""))}
            for q in test_questions]


def convert_vizwiz_for_submission(rows: Sequence[dict],
                                  test_questions: Sequence[dict]) -> List[dict]:
    """-> [{'image', 'answer'}] (convert_vizwiz_for_submission.py)."""
    by_qid = {r["question_id"]: r["text"] for r in rows}
    return [{"image": q["image"],
             "answer": by_qid.get(q["question_id"], "").strip().lower()}
            for q in test_questions]


def convert_seed_for_submission(rows: Sequence[dict],
                                annotations: Sequence[dict]) -> dict:
    """SEED-Bench: accuracy per question-type + overall
    (convert_seed_for_submission.py)."""
    type_by_qid = {str(a["question_id"]): a["question_type_id"]
                   for a in annotations}
    answer_by_qid = {str(a["question_id"]): a["answer"] for a in annotations}
    per_type_total: Dict = {}
    per_type_correct: Dict = {}
    total = correct = 0
    for r in rows:
        qid = str(r["question_id"])
        if qid not in answer_by_qid:
            continue
        t = type_by_qid[qid]
        pred = r["text"].strip().rstrip(".").upper()[:1]
        ok = pred == answer_by_qid[qid]
        per_type_total[t] = per_type_total.get(t, 0) + 1
        per_type_correct[t] = per_type_correct.get(t, 0) + int(ok)
        total += 1
        correct += int(ok)
    return {
        "accuracy": correct / max(total, 1),
        "per_type": {t: per_type_correct.get(t, 0) / per_type_total[t]
                     for t in per_type_total},
        "total": total,
    }


def convert_mmvet_for_eval(rows: Sequence[dict]) -> Dict[str, str]:
    """-> {question_id: answer} json for the MM-Vet GPT-4 grader
    (convert_mmvet_for_eval.py)."""
    return {str(r["question_id"]): r["text"] for r in rows}


def convert_mmbench_for_submission(rows: Sequence[dict], questions_tsv: str,
                                   out_xlsx: str) -> None:
    """Fill the MMBench TSV's 'prediction' column and write xlsx
    (convert_mmbench_for_submission.py)."""
    import pandas as pd

    df = pd.read_table(questions_tsv)
    for col in ("prediction",):
        if col not in df.columns:
            df[col] = None
    pred_by_idx = {r["question_id"]: r["text"] for r in rows}
    df["prediction"] = [pred_by_idx.get(i) for i in df["index"]]
    for col in ("image",):
        if col in df.columns:
            df = df.drop(columns=[col])
    df.to_excel(out_xlsx, index=False, engine="openpyxl")


def convert_sqa_to_llava(problems: Dict[str, dict], split_ids: Sequence[str],
                         options=("A", "B", "C", "D", "E")) -> List[dict]:
    """ScienceQA problems -> llava-style question rows
    (convert_sqa_to_llava.py, single-round QA form)."""
    rows = []
    for pid in split_ids:
        prob = problems[pid]
        ctx = []
        if prob.get("hint"):
            ctx.append(f"Context: {prob['hint']}")
        choice_text = "\n".join(
            f"{options[i]}. {c}" for i, c in enumerate(prob["choices"]))
        question = "\n".join(ctx + [f"Question: {prob['question']}",
                                    "Options:", choice_text])
        rows.append({
            "question_id": pid,
            "image": prob.get("image"),
            "text": question,
            "answer": options[prob["answer"]],
        })
    return rows
