"""Host-side static image-token splice.

The reference builds ragged per-sample sequences on device
(llava_arch.py:236-334).  XLA needs static shapes, so the expansion happens
here on the host with numpy: every IMAGE_TOKEN_INDEX (-200) placeholder in a
tokenized sequence is expanded into `num_image_tokens` reserved slots, and we
emit the gather metadata the model needs:

  input_ids  [T]  — real token ids; 0 at image slots and padding
  labels     [T]  — IGNORE_INDEX at image slots / instruction spans / padding
  segment    [T]  — 1 for real content (text + image slots), 0 for padding
  image_mask [T]  — True at image slots
  image_slot [T]  — m * num_image_tokens + j for the j-th feature of the
                    m-th image of THIS sample (collator adds the batch offset)

Truncation to max_len happens after expansion, matching the reference's
truncate-after-splice (llava_arch.py:279-283).

The port's own copy of llavamod_tpu/data/splice.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from llavamod_tpu_torch.constants import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    VIDEO_TOKEN_INDEX,
)


@dataclasses.dataclass
class SplicedSample:
    input_ids: np.ndarray
    labels: np.ndarray
    segment: np.ndarray
    image_mask: np.ndarray
    image_slot: np.ndarray
    num_images: int
    length: int  # unpadded length (after truncation)
    num_videos: int = 0


def expand_image_tokens(
    input_ids: Sequence[int],
    labels: Optional[Sequence[int]],
    *,
    num_image_tokens: int,
    max_len: int,
    max_images: int,
    pad_id: int = 0,
    pad_side: str = "right",
    num_video_tokens: int = 0,
    max_videos: int = 1,
) -> SplicedSample:
    """Expand IMAGE_TOKEN_INDEX / VIDEO_TOKEN_INDEX placeholders.

    The per-sample feature table is laid out [image rows | video rows]:
    image m's feature j lives at slot m*num_image_tokens + j, video v's
    token j at max_images*num_image_tokens + v*num_video_tokens + j; the
    collator adds the batch offset (b * table width) so image_pos indexes
    the model's flattened per-batch media table (llava.multimodal_embed).
    """
    ids = list(input_ids)
    labs = list(labels) if labels is not None else [IGNORE_INDEX] * len(ids)
    assert len(ids) == len(labs)

    video_base = max_images * num_image_tokens
    out_ids: List[int] = []
    out_labs: List[int] = []
    out_mask: List[bool] = []
    out_slot: List[int] = []
    img_idx = 0
    vid_idx = 0
    for tok, lab in zip(ids, labs):
        if tok == IMAGE_TOKEN_INDEX:
            if img_idx >= max_images:
                # over-budget images are dropped entirely (reference clamps the
                # count in preprocess_multimodal, data_utils.py:125-128)
                continue
            base = img_idx * num_image_tokens
            out_ids.extend([0] * num_image_tokens)
            out_labs.extend([IGNORE_INDEX] * num_image_tokens)
            out_mask.extend([True] * num_image_tokens)
            out_slot.extend(range(base, base + num_image_tokens))
            img_idx += 1
        elif tok == VIDEO_TOKEN_INDEX:
            if vid_idx >= max_videos or num_video_tokens <= 0:
                continue
            base = video_base + vid_idx * num_video_tokens
            out_ids.extend([0] * num_video_tokens)
            out_labs.extend([IGNORE_INDEX] * num_video_tokens)
            out_mask.extend([True] * num_video_tokens)
            out_slot.extend(range(base, base + num_video_tokens))
            vid_idx += 1
        else:
            out_ids.append(tok)
            out_labs.append(lab)
            out_mask.append(False)
            out_slot.append(0)

    length = min(len(out_ids), max_len)

    def fit(vals, fill):
        arr = vals[:max_len]
        pad = [fill] * (max_len - len(arr))
        return np.asarray(pad + arr if pad_side == "left" else arr + pad)

    if pad_side == "left":
        segment = np.concatenate([np.zeros(max_len - length, np.int32),
                                  np.ones(length, np.int32)])
    else:
        segment = np.concatenate([np.ones(length, np.int32),
                                  np.zeros(max_len - length, np.int32)])

    return SplicedSample(
        input_ids=fit(out_ids, pad_id).astype(np.int32),
        labels=fit(out_labs, IGNORE_INDEX).astype(np.int32),
        segment=segment,
        image_mask=fit(out_mask, False).astype(bool),
        image_slot=fit(out_slot, 0).astype(np.int32),
        num_images=img_idx,
        length=length,
        num_videos=vid_idx,
    )
