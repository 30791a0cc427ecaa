"""VQA answer normalization and accuracy metrics.

Fresh implementation of the standard EvalAI/VQA-v2 answer-processing rules
(the reference vendors them in eval/m4c_evaluator.py:7-220): lowercase,
strip punctuation with the comma/number special cases, digit-word mapping,
article removal, contraction fixes.  Metrics:
  * VQA soft accuracy  — min(#humans agreeing / 3, 1), averaged over the 10
    leave-one-out splits (m4c_evaluator.py:221-275 semantics).
  * ANLS               — average normalized Levenshtein similarity
    (m4c_evaluator.py:276-334 semantics, threshold 0.5).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

# The standard EvalAI contraction table (originally from facebookresearch/
# mmf pythia/tasks/processors.py; the reference vendors the same constants
# at m4c_evaluator.py:14-135).  Both apostrophe placements of each 've
# variant are distinct keys — collapsing them changes TextVQA/VQAv2 scores.
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id've": "I'd've",
    "I'dve": "I'd've", "Im": "I'm", "Ive": "I've", "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've", "itll": "it'll",
    "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "mightve": "might've", "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've", "oclock": "o'clock",
    "oughtnt": "oughtn't", "ow's'at": "'ow's'at", "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at", "shant": "shan't", "shed've": "she'd've",
    "she'dve": "she'd've", "she's": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyd've": "they'd've", "they'dve": "they'd've", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed've": "we'd've", "we'dve": "we'd've",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = list(";/[]\"{}()=+\\_-><@`,?!")


def _process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (
                _COMMA_STRIP.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def _process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = _NUMBER_WORDS.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def normalize_vqa_answer(answer: str) -> str:
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = _process_punctuation(answer)
    answer = _process_digit_article(answer)
    return answer


class TextVQAAccuracy:
    """VQA soft accuracy over normalized answers."""

    def _score(self, pred: str, gts: List[str]) -> float:
        pred = normalize_vqa_answer(pred)
        gts = [normalize_vqa_answer(g) for g in gts]
        if len(gts) == 1:
            return float(pred == gts[0])
        accs = []
        for i in range(len(gts)):
            others = gts[:i] + gts[i + 1:]
            matches = sum(1 for g in others if g == pred)
            accs.append(min(1.0, matches / 3.0))
        return sum(accs) / len(accs)

    def eval_pred_list(self, pred_list: Sequence[Dict]) -> float:
        if not pred_list:
            return 0.0
        scores = [self._score(e["pred_answer"], list(e["gt_answers"]))
                  for e in pred_list]
        return sum(scores) / len(scores)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls_score(pred: str, gts: Sequence[str], threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity for one prediction."""
    best = 0.0
    p = " ".join(pred.strip().lower().split())
    for gt in gts:
        g = " ".join(gt.strip().lower().split())
        if not p and not g:
            best = max(best, 1.0)
            continue
        dist = _levenshtein(p, g)
        denom = max(len(p), len(g))
        sim = 1.0 - dist / denom if denom else 0.0
        best = max(best, sim)
    return best if best >= threshold else 0.0


def anls_eval(pred_list: Sequence[Dict]) -> float:
    if not pred_list:
        return 0.0
    return sum(anls_score(e["pred_answer"], e["gt_answers"])
               for e in pred_list) / len(pred_list)
