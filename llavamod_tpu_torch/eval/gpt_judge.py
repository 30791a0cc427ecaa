"""LLM-judge eval machinery (network-free core).

Ports the portable parts of the reference's GPT-4 judging pipeline —
eval_gpt_review.py (pairwise answer review against the rule.json rubric),
eval_gpt_mmhal.py (MMHal-Bench rating rubric), eval_gpt_objhal.py (object
extraction + CHAIR metrics), summarize_gpt_review.py — with the network
call abstracted behind a `complete_fn(content) -> str` callable.  In this
zero-egress environment users plug any local model; with the `openai`
package installed `openai_complete_fn()` restores the reference behavior
(gpt-4, temperature 0.2, retry on rate limit).

Rubric texts live in eval/rubrics/ as data files: rule.json (pairwise
category prompts, reference eval/table/rule.json), mmhal_judge.txt (the
published MMHal-Bench judge prompt), objhal_extract.txt (the object-
extraction prompt).  They must be byte-stable for comparable scores.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_RUBRIC_DIR = os.path.join(os.path.dirname(__file__), "rubrics")

JUDGE_SYSTEM_PROMPT = ("You are a helpful and precise assistant for checking "
                       "the quality of the answer.")


def load_rubric(name: str) -> str:
    with open(os.path.join(_RUBRIC_DIR, name)) as fh:
        return fh.read()


def load_rules(path: Optional[str] = None) -> Dict[str, dict]:
    with open(path or os.path.join(_RUBRIC_DIR, "rule.json")) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# pairwise review (eval_gpt_review.py)
# ---------------------------------------------------------------------------

def build_review_content(question: dict, ans1: dict, ans2: dict,
                         rule: dict, context: Optional[str] = None) -> str:
    """The [Question]/[Assistant 1]/[Assistant 2]/[System] review prompt
    (eval_gpt_review.py:93-97); `context` prepends the [Context] block the
    bench/visual variants use (eval_gpt_review_bench.py:96-101,
    eval_gpt_review_visual.py:94-99)."""
    role = rule["role"]
    head = f"[Context]\n{context}\n\n" if context is not None else ""
    return (head
            + f'[Question]\n{question["text"]}\n\n'
            f'[{role} 1]\n{ans1["text"]}\n\n[End of {role} 1]\n\n'
            f'[{role} 2]\n{ans2["text"]}\n\n[End of {role} 2]\n\n'
            f'[System]\n{rule["prompt"]}\n\n')


def review_context(question: dict, contexts: Dict[str, dict],
                   variant: str) -> Tuple[Optional[str], str]:
    """(context block, rule category) per review variant.

      * 'default' — no context, category = question category or 'default'
        (eval_gpt_review.py).
      * 'bench'   — the image's caption(s), category prefixed with
        'llava_bench_' (eval_gpt_review_bench.py:84-90).
      * 'visual'  — captions + 'category: bbox' lines from the image's COCO
        instances (eval_gpt_review_visual.py:84-93).
    """
    if variant == "default":
        return None, question.get("category", "default")
    inst = contexts[question["image"]]
    if variant == "bench":
        cap = inst["caption"]
        cap_str = "\n".join(cap) if isinstance(cap, list) else cap
        return cap_str, "llava_bench_" + question["category"]
    if variant == "visual":
        cap_str = "\n".join(inst["captions"])
        box_str = "\n".join(f'{i["category"]}: {i["bbox"]}'
                            for i in inst["instances"])
        return f"{cap_str}\n\n{box_str}", question["category"]
    raise ValueError(f"unknown review variant: {variant}")


def parse_score_pair(review: str) -> List[float]:
    """First line 'x y' -> [x, y]; [-1, -1] on malformed reviews
    (eval_gpt_review.py:39-52)."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
    except (ValueError, IndexError):
        pass
    return [-1.0, -1.0]


def review_answers(questions: Sequence[dict], answers1: Sequence[dict],
                   answers2: Sequence[dict],
                   complete_fn: Callable[[str], str],
                   rules: Optional[Dict[str, dict]] = None,
                   contexts: Optional[Dict[str, dict]] = None,
                   variant: str = "default",
                   resume_rows: Optional[Sequence[dict]] = None) -> List[dict]:
    """Run the pairwise judge over aligned question/answer lists; returns
    the reviews-jsonl rows (id/question_id/answer ids/category/content/
    tuple) the summarizer consumes.

    variant 'bench'/'visual' prepend the image-context block (requires
    `contexts`: image name -> caption/instances record).  resume_rows
    implements the variants' append-resume: the first len(resume_rows)
    pairs are taken from the existing file instead of re-judged
    (eval_gpt_review_bench.py:67-75,110-113)."""
    rules = rules or load_rules()
    rows = list(resume_rows or [])
    for idx, (q, a1, a2) in enumerate(zip(questions, answers1, answers2)):
        if idx < len(rows):
            continue  # already reviewed in a previous (interrupted) run
        context, category = review_context(q, contexts or {}, variant)
        rule = rules.get(category, rules["default"])
        content = build_review_content(q, a1, a2, rule, context=context)
        review = complete_fn(content)
        rows.append({
            "id": idx + 1,
            "question_id": q["question_id"],
            "answer1_id": a1.get("answer_id"),
            "answer2_id": a2.get("answer_id"),
            "category": category,
            "content": review,
            "tuple": parse_score_pair(review),
        })
    return rows


def summarize_reviews(rows: Iterable[dict]) -> Dict[str, dict]:
    """Per-category means: relative score (ans2/ans1 %), and both means x10
    (summarize_gpt_review.py:43-60)."""
    scores: Dict[str, List[List[float]]] = defaultdict(list)
    for row in rows:
        t = row.get("tuple", row.get("score"))
        if "category" in row:
            scores[row["category"]].append(t)
        scores["all"].append(t)
    out = {}
    for k, v in sorted(scores.items()):
        n = len(v)
        m1 = sum(x[0] for x in v) / n
        m2 = sum(x[1] for x in v) / n
        out[k] = {"relative": round(m2 / m1 * 100, 1) if m1 else 0.0,
                  "score1": round(m1 * 10, 1), "score2": round(m2 * 10, 1),
                  "count": n}
    return out


# ---------------------------------------------------------------------------
# MMHal-Bench judge (eval_gpt_mmhal.py)
# ---------------------------------------------------------------------------

def build_mmhal_prompt(record: dict) -> str:
    """record: {image_content: [..], question, gt_answer, model_answer}."""
    template = load_rubric("mmhal_judge.txt")
    return template.format(", ".join(record["image_content"]),
                           record["question"], record["gt_answer"],
                           record["model_answer"])


def parse_mmhal_rating(review: str) -> int:
    """'Rating: N' extraction; 0 on ambiguity (eval_gpt_mmhal.py:141-153)."""
    found = [s for s in range(7) if f"rating: {s}" in review.lower()]
    return found[0] if len(found) == 1 else 0


def summarize_mmhal(scores: Sequence[int],
                    num_question_types: int = 8) -> Dict[str, Any]:
    """Average score, hallucination rate (rating < 3), per-type means
    assuming the fixed 96-question type cycle (eval_gpt_mmhal.py:155-169)."""
    n = len(scores)
    halluc = [1 if s < 3 else 0 for s in scores]
    per_type: List[List[int]] = [[] for _ in range(num_question_types)]
    for i, s in enumerate(scores):
        per_type[i % num_question_types].append(s)
    return {
        "average_score": round(sum(scores) / max(n, 1), 2),
        "hallucination_rate": round(sum(halluc) / max(n, 1), 2),
        "scores_per_type": [round(sum(t) / len(t), 2) if t else 0.0
                            for t in per_type],
    }


# ---------------------------------------------------------------------------
# Object-HalBench: object extraction + CHAIR (eval_gpt_objhal.py)
# ---------------------------------------------------------------------------

def build_objhal_extract_prompt(question: str, answer: str) -> str:
    template = load_rubric("objhal_extract.txt")
    return template.replace("{question}", question).replace("{answer}", answer)


def parse_object_list(content: str) -> List[str]:
    """Parse the judge's 'objects: a, b, c' style extraction output
    (eval_gpt_objhal.py:33-45 semantics, json-or-lines tolerant)."""
    content = content.strip()
    try:
        data = json.loads(content)
        if isinstance(data, list):
            return [str(x).strip().lower() for x in data]
    except json.JSONDecodeError:
        pass
    line = content.splitlines()[-1] if content else ""
    if ":" in line:
        line = line.split(":", 1)[1]
    return [w.strip().lower() for w in line.split(",") if w.strip()]


def _chair_table(synonyms: Optional[Dict[str, Iterable[str]]],
                 double_words) -> Tuple[Optional[Dict[str, str]],
                                        Dict[str, str]]:
    """(inverse synonym table {word: canonical object} or None,
    {double word: the word it merges into})."""
    inverse = None
    if synonyms is not None:
        inverse = {}
        for obj, words in synonyms.items():
            inverse[obj.lower()] = obj.lower()
            for w in words:
                inverse[w.lower()] = obj.lower()
    if double_words is None:
        double_words = {}
    elif not isinstance(double_words, dict):
        double_words = {w: w for w in double_words}
    return inverse, {k.lower(): v.lower() for k, v in double_words.items()}


def _chair_words(mention: str, double_words: Dict[str, str]) -> List[str]:
    """One extracted mention -> its words, consecutive pairs that form a
    double word ('motor bike') merged into the word they stand for."""
    words = mention.lower().split()
    out, i = [], 0
    while i < len(words):
        pair = " ".join(words[i:i + 2])
        if i + 1 < len(words) and pair in double_words:
            out.append(double_words[pair])
            i += 2
        else:
            out.append(words[i])
            i += 1
    return out


def compute_chair(records: Sequence[dict],
                  synonyms: Optional[Dict[str, Iterable[str]]] = None,
                  double_words=None) -> Dict[str, Any]:
    """CHAIR metrics over pre-extracted object lists.

    records: [{'pred_objects': [...], 'gt_objects': [...]}].
    CHAIRs = captions with >=1 hallucinated object / captions;
    CHAIRi = hallucinated object mentions / all object mentions
    (eval_gpt_objhal.py:437-527 math).

    With no table (the default) an object is matched by its raw lower-cased
    string, as the JAX package's `compute_chair` does, so 'bike' against a
    ground-truth 'bicycle' counts as a hallucination.  With a table the
    mechanism of the public CHAIR metric (Rohrbach et al., EMNLP 2018) runs
    before matching:

      * `double_words` ({'motor bike': 'motorbike', ...}, or a list of
        phrases that stand for themselves): two consecutive words that form
        one merge into one word;
      * `synonyms` ({canonical object: [synonym, ...]}): every predicted and
        ground-truth word maps through the inverse table to its canonical
        object (a ground-truth word outside the table stays as it is);
      * only the predicted words that map to an object of the table count
        as mentions (the object-vocabulary filter).

    The public metric ships COCO's 80-object synonym list and double-word
    list and reads the ground truth from COCO annotations; neither is in
    this repository, so the caller injects the table and nothing is
    fetched."""
    inverse, doubles = _chair_table(synonyms, double_words)
    tabled = inverse is not None or bool(doubles)

    def objects(mentions, keep_unknown: bool) -> List[str]:
        if not tabled:
            return [w.lower() for w in mentions]
        words = [w for m in mentions for w in _chair_words(m, doubles)]
        if inverse is None:
            return words
        return [inverse.get(w, w) for w in words
                if keep_unknown or w in inverse]

    num_caps = len(records)
    halluc_caps = 0
    halluc_words = 0
    total_words = 0
    per_record = []
    for rec in records:
        gt = set(objects(rec["gt_objects"], keep_unknown=True))
        pred = objects(rec["pred_objects"], keep_unknown=False)
        bad = [w for w in pred if w not in gt]
        halluc_caps += bool(bad)
        halluc_words += len(bad)
        total_words += len(pred)
        per_record.append({"hallucinated": sorted(set(bad)),
                           "CHAIRs": int(bool(bad)),
                           "CHAIRi": len(bad) / len(pred) if pred else 0.0})
    return {
        "CHAIRs": halluc_caps / max(num_caps, 1),
        "CHAIRi": halluc_words / max(total_words, 1),
        "records": per_record,
    }


def qa_baseline(questions: Sequence[dict],
                complete_fn: Callable[[str], str],
                model_id: str = "gpt-3.5-turbo:20230327",
                max_workers: int = 32,
                retries: int = 3) -> List[dict]:
    """Text-only baseline answer generation (reference
    eval/qa_baseline_gpt35.py:16-74): thread-pooled completion per question,
    up to `retries` attempts, '#ERROR#' sentinel on failure, rows sorted by
    question_id.  Transport is the same injected `complete_fn` the judges
    use ('You are a helpful assistant.' is the caller's concern there; here
    the prompt is the raw question text, matching the reference)."""
    import concurrent.futures
    import uuid

    def get_answer(qid, text):
        row = {"answer_id": uuid.uuid4().hex[:22], "question_id": qid,
               "model_id": model_id}
        for _ in range(retries):
            try:
                row["text"] = complete_fn(text)
                return row
            except Exception as exc:  # noqa: BLE001 - reference behavior
                print(f"[ERROR] {exc}")
                row["text"] = "#ERROR#"
                time.sleep(1)
        return row

    rows: List[dict] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = [ex.submit(get_answer, q["question_id"], q["text"])
                for q in questions]
        for f in concurrent.futures.as_completed(futs):
            rows.append(f.result())
    rows.sort(key=lambda r: r["question_id"])
    return rows


# ---------------------------------------------------------------------------
# optional OpenAI transport (reference get_eval, eval_gpt_review.py:13-36)
# ---------------------------------------------------------------------------

def openai_complete_fn(model: str = "gpt-4", temperature: float = 0.2,
                       max_tokens: int = 1024, sleep_s: float = 3.0):
    """Reference-behavior completion callable; needs the openai package and
    network access (absent here — tests inject a stub)."""
    import openai  # pragma: no cover - gated on availability

    def complete(content: str) -> str:  # pragma: no cover
        while True:
            try:
                resp = openai.ChatCompletion.create(
                    model=model,
                    messages=[{"role": "system",
                               "content": JUDGE_SYSTEM_PROMPT},
                              {"role": "user", "content": content}],
                    temperature=temperature, max_tokens=max_tokens)
                return resp["choices"][0]["message"]["content"]
            except Exception as exc:
                print(f"judge call failed ({exc}); retrying")
                time.sleep(sleep_s)

    return complete
