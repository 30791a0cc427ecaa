"""Benchmark-specific question adapters.

Each adapter converts one benchmark's on-disk format into the generic
question dicts `VQARunner` consumes ({question_id, text, image|_pil_image,
_extra}), reproducing the prompt construction of the reference's per-
benchmark generator scripts:

  * mmbench  — pandas-style TSV with base64 images, hint prepend, A-D option
    listing with NaN cutoff, circular option rotation under --all-rounds,
    and the single-letter answer suffix (model_vqa_mmbench.py:19-52,80-194)
  * sqa      — ScienceQA: conversations[0] question, optional image,
    single-letter answer suffix; CoT 2-phase handled by the scorer
    (model_vqa_science.py:25-120)
  * mmhal    — jsonl {question, image_file} + optional test prompt
    (model_vqa_mmhal.py:20-75)
  * objhal   — jsonl {question_id, question, image(base64)}
    (model_vqa_objhal.py:44-70)
  * qbench   — json {img_path, question, candidates} with en/zh option
    preamble (model_vqa_qbench.py:30-95)
  * generic  — the plain question.jsonl family (model_vqa_loader.py).

Everything is torch/pandas-free: TSV via csv, base64 via mm_utils.
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Any, Dict, List, Optional

from llavamod_tpu_torch.mm_utils import load_image_from_base64

ALL_OPTIONS = ["A", "B", "C", "D"]
SINGLE_PRED_EN = "\nAnswer with the option's letter from the given choices directly."
SINGLE_PRED_CN = "\n请直接回答选项字母。"


def is_none(value: Any) -> bool:
    """NaN/None/'nan'/'none' detection (model_vqa_mmbench.py:33-42)."""
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none", ""):
        return True
    return False


def get_options(row: Dict[str, Any], options=ALL_OPTIONS) -> List[str]:
    """Collect consecutive non-empty option columns (mmbench.py:45-52)."""
    parsed = []
    for option in options:
        v = row.get(option)
        if is_none(v):
            break
        parsed.append(v)
    return parsed


def read_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def mmbench_questions(tsv_path: str, *, all_rounds: bool = False,
                      single_pred_prompt: bool = True,
                      lang: str = "en") -> List[dict]:
    """MMBench TSV -> question dicts; one dict per (row, circular round)."""
    out = []
    for row in read_tsv(tsv_path):
        options = get_options(row)
        option_chars = ALL_OPTIONS[:len(options)]
        rounds = len(options) if all_rounds else 1
        opts, chars = list(options), list(option_chars)
        for round_idx in range(rounds):
            question = row["question"]
            if not is_none(row.get("hint")):
                question = row["hint"] + "\n" + question
            for ch, opt in zip(ALL_OPTIONS[:len(opts)], opts):
                question = question + "\n" + ch + ". " + opt
            if single_pred_prompt:
                question += SINGLE_PRED_CN if lang == "cn" else SINGLE_PRED_EN
            pil = None
            if not is_none(row.get("image")):
                try:
                    pil = load_image_from_base64(row["image"])
                except Exception:
                    pil = None
            out.append({
                "question_id": row["index"],
                "text": question,
                "_pil_image": pil,
                "_extra": {"round_id": round_idx, "options": list(opts),
                           "option_char": list(chars)},
            })
            # circular shift for the next round (mmbench.py:192-194)
            opts = opts[1:] + opts[:1]
            chars = chars[1:] + chars[:1]
    return out


def sqa_questions(question_file: str, *, single_pred_prompt: bool = True
                  ) -> List[dict]:
    """ScienceQA llava-format json -> question dicts
    (model_vqa_science.py:42-72; context/options already baked into the
    conversations by convert_sqa_to_llava)."""
    questions = json.load(open(os.path.expanduser(question_file)))
    out = []
    for line in questions:
        q = line["conversations"][0]["value"].replace("<image>", "").strip()
        if single_pred_prompt:
            q = q + SINGLE_PRED_EN
        out.append({
            "question_id": line["id"],
            "text": q,
            "image": line.get("image"),
        })
    return out


def mmhal_questions(question_file: str, *, test_prompt: str = "") -> List[dict]:
    """MMHal-Bench jsonl (model_vqa_mmhal.py:41-60); rows pass through the
    original record so eval_gpt_mmhal can re-attach image_content etc."""
    out = []
    for i, raw in enumerate(open(os.path.expanduser(question_file))):
        line = json.loads(raw)
        out.append({
            "question_id": line.get("question_id", i),
            "text": line["question"] + test_prompt,
            "image": line["image_file"],
            "_extra": {"question": line["question"],
                       "image_id": line.get("image_id"),
                       "image_src": line.get("image_src"),
                       "image_content": line.get("image_content"),
                       "gt_answer": line.get("gt_answer"),
                       "question_type": line.get("question_type")},
        })
    return out


def objhal_questions(question_file: str) -> List[dict]:
    """Object-HalBench jsonl with base64 images (model_vqa_objhal.py:51-69)."""
    out = []
    for raw in open(os.path.expanduser(question_file)):
        line = json.loads(raw)
        pil = load_image_from_base64(line["image"])
        out.append({
            "question_id": line["question_id"],
            "text": line["question"],
            "_pil_image": pil,
            "_extra": {"question": line["question"]},
        })
    return out


def qbench_questions(question_file: str, *, lang: str = "en") -> List[dict]:
    """Q-Bench LLVQA json (model_vqa_qbench.py:36-48)."""
    data = json.load(open(os.path.expanduser(question_file)))
    out = []
    for i, lld in enumerate(data):
        if lang == "en":
            message = lld["question"] + "\nChoose between one of the options as follows:\n"
        elif lang == "zh":
            message = lld["question"] + "\在下列选项中选择一个:\n"
        else:
            raise NotImplementedError(f"Q-Bench language {lang!r}")
        for choice, ans in zip(["A.", "B.", "C.", "D."], lld["candidates"]):
            message += f"{choice} {ans}\n"
        out.append({
            "question_id": lld.get("id", i),
            "text": message,
            "image": lld["img_path"],
            "_extra": {"candidates": lld["candidates"],
                       "correct_ans": lld.get("correct_ans")},
        })
    return out


def generic_questions(question_file: str) -> List[dict]:
    """question.jsonl / json list with {question_id|id, text|question, image}."""
    path = os.path.expanduser(question_file)
    if path.endswith(".jsonl"):
        return [json.loads(l) for l in open(path)]
    return json.load(open(path))


TASKS = {
    "generic": generic_questions,
    "mmbench": mmbench_questions,
    "sqa": sqa_questions,
    "mmhal": mmhal_questions,
    "objhal": objhal_questions,
    "qbench": qbench_questions,
}
