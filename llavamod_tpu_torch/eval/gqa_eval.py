"""Full official GQA metric suite.

Port of the reference's eval_gqa.py semantics (llavamod/eval/eval_gqa.py,
498 LoC — itself the official GQA evaluation script): accuracy (+ per
structural/semantic type, per question length, per reasoning-step count,
binary/open), consistency over entailed questions, validity & plausibility
against the choices file, and the answer-distribution chi-square.  Metrics
are computed over the balanced split only, exactly like the official script.

The grounding (attention-map) metric is exposed but optional — it needs
scene graphs + attention dumps, which the pipeline of record never produces
(shells/eval/gqa.sh uses accuracy only).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, List, Mapping, Optional


def _to_score(b: bool) -> float:
    return 1.0 if b else 0.0


def _avg(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _words_num(question: dict) -> int:
    return len(question["question"].split())


def _steps_num(question: dict) -> int:
    """Reasoning steps, excluding final naming/existence ops
    (eval_gqa.py:220-223)."""
    out = 0
    for c in question.get("semantic", ()):
        tag = "{}: {}".format(c.get("operation", ""), c.get("argument", ""))
        if not any(o in tag for o in ("exist", "query: name", "choose name")):
            out += 1
    return out


def _belongs(element: str, group: Iterable[str], question: dict) -> bool:
    """Validity/plausibility membership; 'Common' questions accept any
    attribute family answer (eval_gqa.py:246-251)."""
    if "Common" in question.get("types", {}).get("detailed", ""):
        group = ["color", "material", "shape"]
    return element in group


def _chi_square(gold: Mapping[str, Mapping[str, int]],
                predicted: Mapping[str, Mapping[str, int]]) -> float:
    """Group-weighted chi-square of predicted vs gold answer histograms
    (eval_gqa.py:359-375)."""
    sum_score, sum_overall = 0.0, 0
    for group, gold_hist in gold.items():
        score, overall = 0.0, 0
        for ans, e in gold_hist.items():
            o = predicted[group].get(ans, 0)
            score += (float(o - e) ** 2) / e
            overall += e
        sum_score += score * overall
        sum_overall += overall
    return sum_score / sum_overall if sum_overall else 0.0


def score_gqa_full(
    questions: Dict[str, dict],
    predictions: Mapping[str, str],
    *,
    choices: Optional[Dict[str, dict]] = None,
    consistency: bool = True,
) -> Dict[str, Any]:
    """questions: qid -> official GQA question dict (answer, isBalanced,
    types, groups, entailed, semantic, question).
    predictions: qid -> predicted answer string.
    choices: qid -> {'valid': [...], 'plausible': [...]} (val_choices.json).

    Returns percentages like the official printout: accuracy, binary, open,
    validity, plausibility, consistency, distribution (chi-square / 100),
    accuracyPerStructuralType / PerSemanticType / PerLength / PerSteps.
    """
    scores: Dict[str, List[float]] = defaultdict(list)
    per: Dict[str, Dict[Any, List[float]]] = {
        "accuracyPerStructuralType": defaultdict(list),
        "accuracyPerSemanticType": defaultdict(list),
        "accuracyPerLength": defaultdict(list),
        "accuracyPerSteps": defaultdict(list),
    }
    dist_gold: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    dist_pred: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))

    for qid, q in questions.items():
        if not q.get("isBalanced", True):
            continue
        gold = q["answer"]
        predicted = predictions.get(qid, "")
        correct = predicted == gold
        score = _to_score(correct)

        scores["accuracy"].append(score)
        per["accuracyPerLength"][_words_num(q)].append(score)
        per["accuracyPerSteps"][_steps_num(q)].append(score)
        types = q.get("types", {})
        per["accuracyPerStructuralType"][types.get("structural", "?")].append(score)
        per["accuracyPerSemanticType"][types.get("semantic", "?")].append(score)
        answer_type = "open" if types.get("structural") == "query" else "binary"
        scores[answer_type].append(score)

        if choices is not None and qid in choices:
            scores["validity"].append(_to_score(
                _belongs(predicted, choices[qid]["valid"], q)))
            scores["plausibility"].append(_to_score(
                _belongs(predicted, choices[qid]["plausible"], q)))

        global_group = q.get("groups", {}).get("global")
        if global_group is not None:
            dist_gold[global_group][gold] += 1
            dist_pred[global_group][predicted] += 1

        # consistency over entailed questions, counted only when the source
        # question is answered correctly (eval_gqa.py:257-269)
        if consistency and correct:
            inferred = [e for e in q.get("entailed", ()) if e != qid]
            if inferred:
                cs = [_to_score(predictions.get(e, "") == questions[e]["answer"])
                      for e in inferred if e in questions]
                if cs:
                    scores["consistency"].append(_avg(cs))

    out: Dict[str, Any] = {
        k: _avg(v) * 100 for k, v in scores.items()
    }
    out["distribution"] = _chi_square(dist_gold, dist_pred) / 100
    out["count"] = len(scores["accuracy"])
    for name, groups in per.items():
        out[name] = {t: (round(_avg(v) * 100, 2), len(v))
                     for t, v in sorted(groups.items(), key=lambda kv: str(kv[0]))}
    return out
