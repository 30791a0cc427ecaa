"""Benchmark scorers (pure-python, no device code).

Semantics parity with the reference scorers; each returns a metrics dict
instead of printing, with thin CLI wrappers in llavamod_tpu_torch/eval/cli.py.

  * score_pope       == eval/eval_pope.py (yes/no P/R/F1 per category)
  * score_science_qa == eval/eval_science_qa.py (answer-letter extraction)
  * score_textvqa    == eval/eval_textvqa.py (+ m4c normalizer)
  * score_gqa        == eval/eval_gqa_1.py core (binary/open/overall accuracy,
    per-structural-type; distribution/consistency need the official scene
    metadata and are computed when provided)
  * score_mme        == the official MME calculation (acc & acc+ per task,
    perception/cognition totals) used by shells/eval/mme.sh
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from llavamod_tpu_torch.eval.answer_normalize import TextVQAAccuracy, normalize_vqa_answer


# ---------------------------------------------------------------------------
# POPE
# ---------------------------------------------------------------------------

def _pope_binarize(text: str) -> str:
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def score_pope(answers: Sequence[dict], labels: Sequence[str]) -> Dict[str, float]:
    """answers: [{'text': ...}]; labels: 'yes'/'no' strings, aligned."""
    preds = [1 if _pope_binarize(a["text"]) == "yes" else 0 for a in answers]
    gts = [0 if l == "no" else 1 for l in labels]
    tp = sum(1 for p, g in zip(preds, gts) if p == 1 and g == 1)
    fp = sum(1 for p, g in zip(preds, gts) if p == 1 and g == 0)
    tn = sum(1 for p, g in zip(preds, gts) if p == 0 and g == 0)
    fn = sum(1 for p, g in zip(preds, gts) if p == 0 and g == 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "accuracy": (tp + tn) / max(len(preds), 1),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": sum(preds) / max(len(preds), 1),
    }


def score_pope_dir(question_file: str, result_file: str,
                   annotation_dir: str) -> Dict[str, Dict[str, float]]:
    """Per-category (adversarial/popular/random) POPE scoring from files,
    mirroring the reference __main__ (eval_pope.py:66-83)."""
    questions = {q["question_id"]: q for q in
                 (json.loads(l) for l in open(question_file))}
    answers = [json.loads(l) for l in open(result_file)]
    out = {}
    for fname in sorted(os.listdir(annotation_dir)):
        if not (fname.startswith("coco_pope_") and fname.endswith(".json")):
            continue
        category = fname[len("coco_pope_"):-len(".json")]
        cur = [a for a in answers
               if questions[a["question_id"]]["category"] == category]
        label_by_qid = {json.loads(l)["question_id"]: json.loads(l)["label"]
                        for l in open(os.path.join(annotation_dir, fname))}
        labels = [label_by_qid[a["question_id"]] for a in cur]
        out[category] = score_pope(cur, labels)
    return out


# ---------------------------------------------------------------------------
# ScienceQA
# ---------------------------------------------------------------------------

_SQA_OPTIONS = ("A", "B", "C", "D", "E")
_SQA_PATTERN = re.compile(r"The answer is ([A-Z]).")


def extract_sqa_answer(pred_text: str, options=_SQA_OPTIONS) -> str:
    """Answer-letter extraction (eval_science_qa.py:56-75)."""
    if pred_text in options:
        return pred_text
    if len(pred_text) >= 3 and pred_text[0] in options and pred_text[1:3] == ". ":
        return pred_text[0]
    found = _SQA_PATTERN.findall(pred_text)
    if len(found) == 1:
        return found[0]
    return "FAILED"


def score_science_qa(problems: Dict[str, dict], predictions: Dict[str, dict],
                     options=_SQA_OPTIONS) -> Dict[str, float]:
    """problems: pid -> {'choices': [...], 'answer': int}; predictions:
    pid -> {'text': ...}.  Missing predictions count as failures."""
    correct = 0
    total = 0
    multimodal_correct = 0
    multimodal_total = 0
    for pid, prob in problems.items():
        pred_text = predictions.get(pid, {}).get("text", "FAILED")
        answer = extract_sqa_answer(pred_text, options)
        pred_idx = options.index(answer) if answer in options[:len(prob["choices"])] else -1
        ok = pred_idx == prob["answer"]
        total += 1
        correct += ok
        if prob.get("image"):
            multimodal_total += 1
            multimodal_correct += ok
    return {
        "accuracy": correct / max(total, 1),
        "correct": correct,
        "count": total,
        "multimodal_accuracy": multimodal_correct / max(multimodal_total, 1),
    }


_SQA_ANSWER_RE = re.compile(r"The answer is ([A-Z]).")


def _sqa_letter_or_failed(text: str) -> str:
    """'The answer is X.' extraction; 'FAILED' when not exactly one match
    (eval_science_qa_gpt4.py:60-70)."""
    found = _SQA_ANSWER_RE.findall(text)
    return found[0] if len(found) == 1 else "FAILED"


def _sqa_pred_idx(letter: str, choices, options, rng) -> int:
    """Letter -> choice index; random choice on FAILED/out-of-range
    (eval_science_qa_gpt4.py get_pred_idx — reference uses an unseeded
    random; pass rng for reproducibility)."""
    if letter in options[: len(choices)]:
        return options.index(letter)
    return int(rng.integers(0, len(choices)))


def score_sqa_vs_gpt4(problems: Dict[str, dict], split_indices,
                      our_preds: Dict[str, dict], gpt4_outputs: Dict[str, str],
                      options=_SQA_OPTIONS, seed: int = 0) -> Dict[str, float]:
    """ScienceQA scored through GPT-4's answers with a model-ensemble
    fallback (eval_science_qa_gpt4.py:83-104): when GPT-4 emits no parsable
    answer, the model's prediction substitutes; correct_upperbound counts
    either being right."""
    import numpy as np

    rng = np.random.default_rng(seed)
    correct = incorrect = upper = gpt4_failed = 0
    for pid in split_indices:
        prob = problems.get(pid)
        if prob is None or pid not in our_preds or pid not in gpt4_outputs:
            continue
        ours = _sqa_letter_or_failed(our_preds[pid]["text"])
        gpt4 = _sqa_letter_or_failed(gpt4_outputs[pid])
        our_idx = _sqa_pred_idx(ours, prob["choices"], options, rng)
        gpt4_idx = _sqa_pred_idx(gpt4, prob["choices"], options, rng)
        if gpt4 == "FAILED":
            gpt4_failed += 1
            gpt4_idx = our_idx
        if gpt4_idx == prob["answer"]:
            correct += 1
        else:
            incorrect += 1
        if gpt4_idx == prob["answer"] or our_idx == prob["answer"]:
            upper += 1
    total = max(correct + incorrect, 1)
    return {"total": correct + incorrect, "correct": correct,
            "accuracy": correct / total, "correct_upperbound": upper,
            "upperbound_accuracy": upper / total, "gpt4_failed": gpt4_failed}


def score_sqa_requery(problems: Dict[str, dict], split_indices,
                      our_preds: Dict[str, dict],
                      gpt4_outputs: Dict[str, str],
                      requery_preds: Dict[str, dict],
                      options=_SQA_OPTIONS, seed: int = 0):
    """Requery-ensemble ScienceQA scoring
    (eval_science_qa_gpt4_requery.py:60-120): the requery answer replaces
    the model's where parsable; returns (metrics, per-problem result map)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = {k: 0 for k in ("total", "our_correct", "gpt4_correct",
                        "gpt4_ourvisual_correct", "requery_correct",
                        "gpt4_failed", "missing_requery")}
    result_map: Dict[str, int] = {}
    for pid in split_indices:
        prob = problems.get(pid)
        if prob is None or pid not in our_preds or pid not in gpt4_outputs:
            continue
        requery_text = requery_preds.get(pid, {}).get("text")
        if requery_text is None:
            m["missing_requery"] += 1
            requery_text = "MISSING"
        ours = _sqa_letter_or_failed(our_preds[pid]["text"])
        gpt4 = _sqa_letter_or_failed(gpt4_outputs[pid])
        requery = _sqa_letter_or_failed(requery_text)
        our_idx = _sqa_pred_idx(ours, prob["choices"], options, rng)
        gpt4_idx = _sqa_pred_idx(gpt4, prob["choices"], options, rng)
        req_idx = _sqa_pred_idx(requery, prob["choices"], options, rng)
        m["total"] += 1
        if gpt4 == "FAILED":
            m["gpt4_failed"] += 1
            if gpt4_idx == prob["answer"]:
                m["gpt4_correct"] += 1
            if our_idx == prob["answer"]:
                m["gpt4_ourvisual_correct"] += 1
        elif gpt4_idx == prob["answer"]:
            m["gpt4_correct"] += 1
            m["gpt4_ourvisual_correct"] += 1
        if our_idx == prob["answer"]:
            m["our_correct"] += 1
        if requery == "FAILED":
            result_map[pid] = our_idx
            if our_idx == prob["answer"]:
                m["requery_correct"] += 1
        else:
            result_map[pid] = req_idx
            if req_idx == prob["answer"]:
                m["requery_correct"] += 1
    return m, result_map


# ---------------------------------------------------------------------------
# TextVQA
# ---------------------------------------------------------------------------

def textvqa_prompt_to_question(prompt: str) -> str:
    """Extract the raw question from the eval prompt
    (eval_textvqa.py:17-32 semantics)."""
    if prompt.startswith("OCR tokens: "):
        match = re.search(r"Question: (.*?) Short answer:", prompt, re.DOTALL)
        return match.group(1).lower()
    if "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        lines = prompt.split("\n")
        return (lines[1] if prompt.startswith("Reference OCR token:")
                else lines[0]).lower()
    if len(prompt.split("\n")) == 2:
        return prompt.split("\n")[0].lower()
    raise ValueError(f"unrecognized textvqa prompt format: {prompt!r}")


def score_textvqa(annotations: Sequence[dict],
                  results: Sequence[dict]) -> Dict[str, float]:
    """annotations: [{'image_id', 'question', 'answers'}]; results: jsonl rows
    [{'question_id', 'prompt', 'text'}]."""
    ann = {(a["image_id"], a["question"].lower()): a for a in annotations}
    pred_list = []
    for r in results:
        a = ann[(r["question_id"], textvqa_prompt_to_question(r["prompt"]))]
        pred_list.append({"pred_answer": r["text"], "gt_answers": a["answers"]})
    acc = TextVQAAccuracy().eval_pred_list(pred_list)
    return {"accuracy": acc, "samples": len(pred_list)}


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def score_gqa(questions: Dict[str, dict],
              predictions: Dict[str, str]) -> Dict[str, float]:
    """Core official GQA metrics (eval_gqa_1.py): overall / binary / open
    accuracy, accuracy per structural type and per semantic type.

    questions: qid -> {'answer', 'types': {'structural', 'semantic'}, ...}
    predictions: qid -> predicted answer string.
    """
    scores = defaultdict(list)
    for qid, q in questions.items():
        pred = predictions.get(qid, "")
        correct = float(pred.lower().strip() == q["answer"].lower().strip())
        scores["accuracy"].append(correct)
        structural = q.get("types", {}).get("structural", "unknown")
        semantic = q.get("types", {}).get("semantic", "unknown")
        if structural in ("verify", "logical"):
            scores["binary"].append(correct)
        elif structural in ("query",):
            scores["open"].append(correct)
        scores[f"structural/{structural}"].append(correct)
        scores[f"semantic/{semantic}"].append(correct)

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    return {k: mean(v) for k, v in scores.items()} | {
        "count": len(scores["accuracy"])}


# ---------------------------------------------------------------------------
# MME
# ---------------------------------------------------------------------------

MME_PERCEPTION_TASKS = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR")
MME_COGNITION_TASKS = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning")


def _mme_norm(ans: str) -> str:
    ans = ans.lower().strip().replace(".", "").replace(",", "")
    if ans in ("yes", "no"):
        return ans
    words = ans.split()
    if "yes" in words:
        return "yes"
    if "no" in words:
        return "no"
    return "other"


def score_mme(rows: Sequence[dict]) -> Dict[str, float]:
    """rows: [{'task', 'image_id', 'gt': 'Yes'/'No', 'pred': text}].
    MME score per task = acc + acc+ (acc+ counts an image only if BOTH of its
    two questions are answered correctly), each in percent."""
    by_task_img = defaultdict(lambda: defaultdict(list))
    for r in rows:
        by_task_img[r["task"]][r["image_id"]].append(
            (_mme_norm(r["gt"]), _mme_norm(r["pred"])))

    out: Dict[str, float] = {}
    for task, imgs in by_task_img.items():
        n_q = sum(len(v) for v in imgs.values())
        n_correct = sum(1 for v in imgs.values() for gt, p in v if gt == p)
        n_img = len(imgs)
        n_img_correct = sum(1 for v in imgs.values()
                            if len(v) == 2 and all(gt == p for gt, p in v))
        acc = 100.0 * n_correct / max(n_q, 1)
        acc_plus = 100.0 * n_img_correct / max(n_img, 1)
        out[f"{task}/acc"] = acc
        out[f"{task}/acc_plus"] = acc_plus
        out[f"{task}/score"] = acc + acc_plus

    out["perception_score"] = sum(out.get(f"{t}/score", 0.0)
                                  for t in MME_PERCEPTION_TASKS)
    out["cognition_score"] = sum(out.get(f"{t}/score", 0.0)
                                 for t in MME_COGNITION_TASKS)
    return out


def mme_rows_from_answers(answers: Sequence[dict],
                          questions: Sequence[dict]) -> List[dict]:
    """Join generated answers with MME question metadata into score_mme rows
    (the external convert_answer_to_mme.py step of the reference pipeline,
    shells/eval/mme.sh).  Question rows need a ground-truth field
    ('answer'/'gt'/'label') and ideally 'category'; two questions share an
    image."""
    q_by_id: Dict = {}
    for q in questions:
        q_by_id[str(q.get("question_id", q.get("id")))] = q
    rows = []
    for a in answers:
        qid = str(a["question_id"])
        q = q_by_id.get(qid)
        if q is None:
            continue
        gt = q.get("answer") or q.get("gt") or q.get("label")
        if gt is None:
            continue
        task = q.get("category") or qid.split("/")[0]
        rows.append({"task": task,
                     "image_id": q.get("image", qid),
                     "gt": gt, "pred": a["text"]})
    return rows
