"""The one generator of every traffic mix, driven by the mix's data file
(benchmark/traffic/<name>.json) and the run's seed.

The sizes of the work come from the file alone: the images' sizes, the
training conversations' real token counts (evenly spread over the file's
range), the questions' lengths and the answers' token budgets (each a
fixed list, cycled).  The seed draws the pixels, the words, and the order
in which the sizes are handed out, so every seed does the same amount of
work in another order.

* `conversations`: LLaVA-format single-image conversations for training,
  each with its exact number of real tokens after the image's rows are
  spliced in (the char-level stand-in tokenizer counts one token per
  character), and seeded JPEGs;
* `questions`: image questions for serving, each with its image, its
  question text and its `max_new_tokens`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference import text as rtext


def _rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), sum(map(ord, stream))])


def _words(rng: np.random.Generator, n_chars: int) -> str:
    """Lower-case words of exactly n_chars characters (n_chars >= 1)."""
    out = []
    left = n_chars
    while left > 0:
        w = min(left, int(rng.integers(2, 9)))
        if left - w == 1:       # leave no room for a lone space
            w += 1
        out.append("".join(chr(97 + c) for c in rng.integers(0, 26, w)))
        left -= w + 1
    return " ".join(out)[:n_chars]


def images(mix: dict, seed: int) -> List[np.ndarray]:
    """Seeded uint8 [H, W, 3] images of the mix's sizes (W x H pairs):
    smooth colour fields with noise, so that JPEG and the resize see
    photo-like content."""
    rng = _rng(seed, "images")
    sizes = mix["image_sizes"]
    out = []
    for i in range(mix["images"]):
        w, h = sizes[i % len(sizes)]
        base = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
        big = np.kron(base, np.ones((16, 16, 1), np.float32))[:h, :w]
        noise = rng.normal(0.0, 12.0, (h, w, 3))
        out.append(np.clip(big + noise, 0, 255).astype(np.uint8))
    return out


def _real_tokens(turns, tok, n_image: int) -> int:
    ids, _ = rtext.conversation_ids(turns, tok)
    return len(ids) - 1 + n_image


def conversations(mix: dict, seed: int, tok, n_image: int) -> List[dict]:
    """Training records with real token counts spread evenly over
    mix["real_tokens"] (`n_image` rows for the image), in a seeded
    order."""
    rng = _rng(seed, "conversations")
    lo, hi = mix["real_tokens"]
    n = mix["records"]
    targets = [int(round(lo + (hi - lo) * i / max(1, n - 1))) for i in range(n)]
    targets = [targets[i] for i in rng.permutation(n)]
    qlo, qhi = mix["question_chars"]
    alo, ahi = mix["answer_chars"]
    records = []
    for i, target in enumerate(targets):
        turns = [{"from": "human", "value": "<image>\n" + _words(
            rng, int(rng.integers(qlo, qhi))) + "?"},
                 {"from": "gpt", "value": _words(rng, int(rng.integers(alo, ahi)))}]
        while _real_tokens(turns, tok, n_image) < target - ahi:
            turns += [{"from": "human", "value": _words(
                rng, int(rng.integers(qlo, qhi))) + "?"},
                      {"from": "gpt", "value": _words(rng, int(rng.integers(alo, ahi)))}]
        last = turns[-1]
        need = target - _real_tokens(turns, tok, n_image)
        if len(last["value"]) + need < 2:
            raise ValueError(f"cannot reach {target} real tokens")
        last["value"] = _words(rng, len(last["value"]) + need)
        assert _real_tokens(turns, tok, n_image) == target
        records.append({"id": i, "image": f"{i % mix['images']}.jpg",
                        "conversations": turns})
    return records


def write_conversations(mix: dict, seed: int, tok, n_image: int, root: str
                        ) -> Tuple[str, str, List[dict], List[np.ndarray]]:
    """The records as a JSON file and the images as JPEGs under `root`:
    (data path, image folder, records, images)."""
    import json

    from PIL import Image

    imgs = images(mix, seed)
    folder = os.path.join(root, "images")
    os.makedirs(folder, exist_ok=True)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(folder, f"{i}.jpg"), quality=90)
    records = conversations(mix, seed, tok, n_image)
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path, folder, records, imgs


def questions(mix: dict, seed: int) -> List[Dict]:
    """The serving requests: mix["pool"] questions, each {image index,
    question, max_new_tokens}, in a seeded order."""
    rng = _rng(seed, "questions")
    n = mix["pool"]
    qlo, qhi = mix["question_tokens"]
    lengths = [qlo + (qhi - qlo) * i // max(1, n - 1) for i in range(n)]
    budgets = mix["max_new_tokens"]
    lengths = [lengths[i] for i in rng.permutation(n)]
    news = [budgets[i % len(budgets)] for i in rng.permutation(n)]
    return [{"image": i % mix["images"],
             "question": _words(rng, lengths[i] - 1) + "?",
             "max_new_tokens": int(news[i])} for i in range(n)]
