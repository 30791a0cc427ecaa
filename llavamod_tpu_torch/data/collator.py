"""Collators: samples -> static-shape device batches.

The port's own copy of llavamod_tpu/data/collator.py.  Replaces the reference's ragged collators (data/dataset.py:167-232 supervised,
:434-505 DPO) with fixed-shape numpy batches: every batch is [B, max_len]
after host-side image-slot expansion (data/splice.py), every image tensor is
[B, max_images, 3, S, S] with a validity mask.  Constant shapes let the
caching allocator reuse the same blocks every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from llavamod_tpu_torch.data.splice import SplicedSample, expand_image_tokens


def _stack_spliced(samples: List[SplicedSample], max_images: int,
                   num_image_tokens: int, prefix: str = "",
                   video_rows: int = 0) -> Dict[str, np.ndarray]:
    b = len(samples)
    # per-sample media table = [image rows | video rows] (data/splice.py)
    per_sample_rows = max_images * num_image_tokens + video_rows
    image_pos = np.stack([s.image_slot for s in samples])
    offsets = (np.arange(b) * per_sample_rows)[:, None]
    image_pos = image_pos + offsets  # global row index into [B*M*N, D]
    return {
        prefix + "input_ids": np.stack([s.input_ids for s in samples]),
        prefix + "labels": np.stack([s.labels for s in samples]),
        prefix + "segment_ids": np.stack([s.segment for s in samples]),
        prefix + "image_mask": np.stack([s.image_mask for s in samples]),
        prefix + "image_pos": image_pos.astype(np.int32),
    }


def _stack_pixels(pixel_list: List[Optional[np.ndarray]], max_images: int,
                  image_size: int) -> Dict[str, np.ndarray]:
    b = len(pixel_list)
    pixels = np.zeros((b, max_images, 3, image_size, image_size), np.float32)
    valid = np.zeros((b, max_images), bool)
    for i, px in enumerate(pixel_list):
        if px is None:
            continue
        m = min(px.shape[0], max_images)
        pixels[i, :m] = px[:m]
        valid[i, :m] = True
    return {"pixels": pixels, "pixel_valid": valid}


def _stack_video_pixels(samples: Sequence[Dict[str, Any]], num_frames: int,
                        image_size: int) -> Dict[str, np.ndarray]:
    """video frames [F, 3, S, S] per sample -> [B, F, 3, S, S] + validity
    (frames beyond a sample's real count stay zero; MAX_VIDEO_LENGTH=1
    per reference constants.py:24, so one video slot per sample)."""
    b = len(samples)
    pixels = np.zeros((b, num_frames, 3, image_size, image_size), np.float32)
    valid = np.zeros((b,), bool)
    for i, s in enumerate(samples):
        vx = s.get("video_pixels")
        if vx is None:
            continue
        f = min(vx.shape[0], num_frames)
        pixels[i, :f] = vx[:f]
        valid[i] = True
    return {"video_pixels": pixels, "video_valid": valid}


@dataclasses.dataclass
class SupervisedCollator:
    max_len: int
    num_image_tokens: int
    image_size: int = 336
    max_images: int = 1
    pad_id: int = 0
    # video-projector mode (LlavaConfig.video_projector_type set):
    num_video_tokens: int = 0         # video projector output tokens
    num_video_frames: int = 8         # static per-video frame budget

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        spliced = [
            expand_image_tokens(
                s["input_ids"], s["labels"],
                num_image_tokens=self.num_image_tokens, max_len=self.max_len,
                max_images=self.max_images, pad_id=self.pad_id,
                num_video_tokens=self.num_video_tokens)
            for s in samples
        ]
        batch = _stack_spliced(spliced, self.max_images,
                               self.num_image_tokens,
                               video_rows=self.num_video_tokens)
        batch.update(_stack_pixels([s.get("pixels") for s in samples],
                                   self.max_images, self.image_size))
        if self.num_video_tokens:
            batch.update(_stack_video_pixels(samples, self.num_video_frames,
                                             self.image_size))
        return batch


@dataclasses.dataclass
class DPOCollator:
    """Chosen/rejected pairs share the image tensor (reference :434-505)."""
    max_len: int
    num_image_tokens: int
    image_size: int = 336
    max_images: int = 1
    pad_id: int = 0

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for side in ("chosen", "rejected"):
            spliced = [
                expand_image_tokens(
                    s[f"{side}_input_ids"], s[f"{side}_labels"],
                    num_image_tokens=self.num_image_tokens,
                    max_len=self.max_len, max_images=self.max_images,
                    pad_id=self.pad_id)
                for s in samples
            ]
            batch.update(_stack_spliced(spliced, self.max_images,
                                        self.num_image_tokens,
                                        prefix=f"{side}_"))
        batch.update(_stack_pixels([s.get("pixels") for s in samples],
                                   self.max_images, self.image_size))
        return batch
