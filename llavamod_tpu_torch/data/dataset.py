"""Datasets: lazy JSON-backed supervised and preference (DPO) corpora.

The port's own copy of llavamod_tpu/data/dataset.py (PIL and the port's
`ImagePreprocessor`; the same seeded `random` use).  Parity with the reference's LazySupervisedDataset / LazyDPODataset
(data/dataset.py:25-164, :253-517): multiple JSON files concatenated with
ids reassigned, per-item lazy image loading with a black 224x224 fallback on
IO errors, retry-on-random-other-index for any other exception, multi-image
lists subsampled order-preserving to MAX_IMAGE_LENGTH, and
`modality_lengths` (signed token-ish lengths) for the modality-grouped
batch sampler.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from llavamod_tpu_torch.constants import MAX_IMAGE_LENGTH
from llavamod_tpu_torch.data.preprocess import (
    preprocess_conversations,
    preprocess_multimodal_text,
)
from llavamod_tpu_torch.mm_utils import ImagePreprocessor
from llavamod_tpu_torch.utils.misc import order_pick_k

_FALLBACK_SIZE = 224


def load_json_records(paths: Sequence[str]) -> List[dict]:
    records: List[dict] = []
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        records.extend(data)
    for i, rec in enumerate(records):
        rec["id"] = i
    return records


class _JsonDatasetBase:
    def __init__(self, data_paths: Sequence[str], tokenizer,
                 image_preprocessor: ImagePreprocessor,
                 image_folder: str = "",
                 template_name: str = "qwen",
                 model_max_length: int = 2048,
                 is_multimodal: bool = True,
                 num_frames: int = 8,
                 use_im_start_end: bool = False,
                 seed: int = 0,
                 video_projector: bool = False):
        if isinstance(data_paths, str):
            data_paths = [data_paths]
        self.records = load_json_records(data_paths)
        self.tokenizer = tokenizer
        self.image_preprocessor = image_preprocessor
        self.image_folder = image_folder
        self.template_name = template_name
        self.model_max_length = model_max_length
        self.is_multimodal = is_multimodal
        self.num_frames = num_frames
        self.use_im_start_end = use_im_start_end
        self.video_projector = video_projector
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.records)

    def _load_images(self, rec: dict) -> Optional[np.ndarray]:
        """Load + preprocess the record's image(s) -> [M, 3, S, S] or None."""
        if "image" not in rec:
            return None
        files = rec["image"] if isinstance(rec["image"], list) else [rec["image"]]
        files = order_pick_k(files, MAX_IMAGE_LENGTH, seed=rec.get("id"))
        images = []
        for f in files:
            try:
                img = Image.open(os.path.join(self.image_folder, f)).convert("RGB")
            except (IOError, OSError) as exc:
                print(f"Error opening image {f}: {exc}, using fallback image.")
                img = Image.new("RGB", (_FALLBACK_SIZE, _FALLBACK_SIZE), (0, 0, 0))
            images.append(img)
        return self.image_preprocessor(images)

    def _load_video(self, rec: dict) -> Optional[np.ndarray]:
        """Video-projector mode: the record's 'video' is a list of frame
        image files (or a directory of frames); evenly subsample to
        num_frames (order_pick_k, reference utils.py:17) -> [F, 3, S, S]."""
        if "video" not in rec or not self.video_projector:
            return None
        src = rec["video"]
        if isinstance(src, str) and os.path.isdir(
                os.path.join(self.image_folder, src)):
            d = os.path.join(self.image_folder, src)
            files = [os.path.join(src, f) for f in sorted(os.listdir(d))]
        else:
            files = src if isinstance(src, list) else [src]
        files = order_pick_k(files, self.num_frames, seed=rec.get("id"))
        frames = []
        for f in files:
            try:
                img = Image.open(os.path.join(self.image_folder, f)).convert("RGB")
            except (IOError, OSError) as exc:
                print(f"Error opening frame {f}: {exc}, using fallback.")
                img = Image.new("RGB", (_FALLBACK_SIZE, _FALLBACK_SIZE),
                                (0, 0, 0))
            frames.append(img)
        return self.image_preprocessor(frames)

    def _conversations(self, rec: dict) -> list:
        raise NotImplementedError

    @property
    def modality_lengths(self) -> List[int]:
        """Signed approx lengths: positive = has image, negative = text-only
        (reference dataset.py:52-61); used by the modality-grouped sampler."""
        out = []
        for rec in self.records:
            n_words = sum(len(turn["value"].split())
                          for turn in self._conversations(rec))
            out.append(n_words if "image" in rec or "video" in rec else -n_words)
        return out

    def get(self, i: int) -> Dict[str, Any]:
        raise NotImplementedError

    def __getitem__(self, i: int) -> Dict[str, Any]:
        try:
            return self.get(i)
        except Exception as exc:  # retry another sample (reference :162-164)
            print(f"dataset error at index {i}: {exc}; retrying a random index")
            return self.__getitem__(self._rng.randrange(len(self)))


class SupervisedJsonDataset(_JsonDatasetBase):
    """Records: {'id', 'image'?: str|list, 'conversations': [{'from','value'}]}"""

    def _conversations(self, rec):
        return rec["conversations"]

    def get(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        pixels = self._load_images(rec)
        video_pixels = self._load_video(rec)
        convs = [rec["conversations"]]
        if pixels is not None or video_pixels is not None or self.is_multimodal:
            convs = preprocess_multimodal_text(
                convs, num_frames=self.num_frames,
                use_im_start_end=self.use_im_start_end,
                keep_video_token=self.video_projector)
        tok = preprocess_conversations(convs, self.tokenizer,
                                       self.template_name,
                                       self.model_max_length)
        out = {
            "input_ids": tok.input_ids,
            "labels": tok.labels,
            "pixels": pixels,
            "id": rec["id"],
        }
        if video_pixels is not None:
            out["video_pixels"] = video_pixels
        return out


class PreferenceJsonDataset(_JsonDatasetBase):
    """Records: {'id', 'image'?: ..., 'chosen': [...], 'rejected': [...]}
    (format documented in reference dataset.py:291-314)."""

    def _conversations(self, rec):
        return rec["chosen"]

    def get(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        pixels = self._load_images(rec)
        out: Dict[str, Any] = {"pixels": pixels, "id": rec["id"]}
        for side in ("chosen", "rejected"):
            convs = preprocess_multimodal_text(
                [rec[side]], num_frames=self.num_frames,
                use_im_start_end=self.use_im_start_end)
            tok = preprocess_conversations(convs, self.tokenizer,
                                           self.template_name,
                                           self.model_max_length)
            out[f"{side}_input_ids"] = tok.input_ids
            out[f"{side}_labels"] = tok.labels
        return out
