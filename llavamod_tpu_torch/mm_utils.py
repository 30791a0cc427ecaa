"""Multimodal utilities: image preprocessing and image-aware tokenization.

Torch-free, numpy/PIL host-side versions of the reference's
`llavamod/mm_utils.py`.  Behavior parity:
  * `expand2square`       — mm_utils.py:14-25
  * `process_images`      — mm_utils.py:28-40 (here: ImagePreprocessor)
  * `tokenize_with_images`— mm_utils.py:43-62 (`tokenizer_image_token`)
  * stop-string matching  — mm_utils.py:74-105 (`StopOnKeywords`, for our
    host-side decode loop instead of HF StoppingCriteria)

The port's own copy of llavamod_tpu/mm_utils.py (the port imports nothing
of the JAX package).  `ImagePreprocessor` takes the C++ batch path first
(llavamod_tpu_torch/native, the port's copy of the JAX package's), as the
JAX package does; unlike it, a failed build raises instead of falling back,
and only LLAVAMOD_NO_NATIVE=1 selects the PIL path.
"""

from __future__ import annotations

import base64
import dataclasses
from io import BytesIO
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from llavamod_tpu_torch.constants import IMAGE_TOKEN_INDEX

# CLIP-ViT-L/14-336 normalization constants (OpenAI CLIP preprocessing).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_IMAGE_MEAN = (0.5, 0.5, 0.5)
SIGLIP_IMAGE_STD = (0.5, 0.5, 0.5)


def load_image_from_base64(data: str) -> Image.Image:
    return Image.open(BytesIO(base64.b64decode(data)))


def expand2square(img: Image.Image, background_color) -> Image.Image:
    """Pad a PIL image to a square with the given fill, centering the content."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    canvas = Image.new(img.mode, (side, side), background_color)
    canvas.paste(img, ((side - w) // 2, (side - h) // 2))
    return canvas


@dataclasses.dataclass(frozen=True)
class ImagePreprocessor:
    """Host-side image -> float32 CHW tensor pipeline (CLIP/SigLIP semantics).

    Matches HF CLIPImageProcessor: resize shortest edge to `size` (bicubic),
    center-crop to `size`x`size`, scale to [0,1], channel-normalize.
    """

    size: int = 336
    mean: Sequence[float] = CLIP_IMAGE_MEAN
    std: Sequence[float] = CLIP_IMAGE_STD
    image_aspect_ratio: Optional[str] = None  # None | 'pad'

    @property
    def background_color(self):
        return tuple(int(x * 255) for x in self.mean)

    def preprocess_one(self, img: Image.Image) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        if self.image_aspect_ratio == "pad":
            img = expand2square(img, self.background_color)
        w, h = img.size
        # Resize so the short side equals `size`, then center-crop.
        scale = self.size / min(w, h)
        new_w, new_h = round(w * scale), round(h * scale)
        img = img.resize((new_w, new_h), Image.Resampling.BICUBIC)
        left = (new_w - self.size) // 2
        top = (new_h - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - np.asarray(self.mean, np.float32)) / np.asarray(self.std, np.float32)
        return arr.transpose(2, 0, 1)  # CHW

    def __call__(self, images) -> np.ndarray:
        from llavamod_tpu_torch import native

        if isinstance(images, Image.Image):
            images = [images]
        images = list(images)
        if native.enabled():
            out = self._native_batch(images)
            native.count("native")
            return out
        out = np.stack([self.preprocess_one(im) for im in images], axis=0)
        native.count("pil")
        return out

    def _native_batch(self, images) -> np.ndarray:
        """C++ batch path (llavamod_tpu_torch/native): pad + resize +
        normalize of the whole batch in one call."""
        from llavamod_tpu_torch import native

        arrays = [np.asarray(im if im.mode == "RGB" else im.convert("RGB"),
                             np.uint8) for im in images]
        return native.preprocess_batch(
            arrays, self.size, pad_square=self.image_aspect_ratio == "pad",
            background=self.background_color, mean=self.mean, std=self.std)


def process_images(images, preprocessor: ImagePreprocessor) -> np.ndarray:
    """Batch-preprocess a list of PIL images -> [N, 3, S, S] float32."""
    return preprocessor(images)


def tokenize_with_images(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize a prompt containing '<image>' placeholders.

    Splits on '<image>', tokenizes each text chunk, and splices
    `image_token_index` (-200) between chunks; a leading BOS emitted by the
    tokenizer is kept once at the front and stripped from later chunks.
    Matches reference mm_utils.py:43-62 exactly.  A surviving '<video>'
    placeholder (video-projector mode, see preprocess_multimodal_text)
    becomes VIDEO_TOKEN_INDEX (-201) via the same mechanism.
    """
    from llavamod_tpu_torch.constants import VIDEO_TOKEN_INDEX

    if "<video>" in prompt:
        parts = prompt.split("<video>")
        ids: List[int] = tokenize_with_images(parts[0], tokenizer,
                                              image_token_index)
        for part in parts[1:]:
            ids.append(VIDEO_TOKEN_INDEX)
            chunk = tokenize_with_images(part, tokenizer, image_token_index)
            bos = getattr(tokenizer, "bos_token_id", None)
            if chunk and bos is not None and chunk[0] == bos:
                chunk = chunk[1:]
            ids.extend(chunk)
        return ids
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    bos = getattr(tokenizer, "bos_token_id", None)
    offset = 0
    ids: List[int] = []
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.extend(sep[offset:])
        ids.extend(chunk[offset:])
    return ids


# Reference-named alias (mm_utils.py:43).
def tokenizer_image_token(prompt, tokenizer, image_token_index=IMAGE_TOKEN_INDEX,
                          return_tensors=None):
    ids = tokenize_with_images(prompt, tokenizer, image_token_index)
    if return_tensors == "np":
        return np.asarray(ids, dtype=np.int64)
    if return_tensors is not None:
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return ids


def get_model_name_from_path(model_path: str) -> str:
    parts = model_path.strip("/").split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


class StopOnKeywords:
    """Host-side stop-string detector for the decode loop.

    Equivalent in behavior to the reference's KeywordsStoppingCriteria
    (mm_utils.py:74-105): stops when the generated suffix token ids match a
    keyword's ids, or the decoded suffix text contains the keyword.
    """

    def __init__(self, keywords: Sequence[str], tokenizer, prompt_len: int):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.prompt_len = prompt_len
        self.keyword_ids = []
        self.max_keyword_len = 0
        bos = getattr(tokenizer, "bos_token_id", None)
        for kw in self.keywords:
            kw_ids = tokenizer(kw).input_ids
            if len(kw_ids) > 1 and bos is not None and kw_ids[0] == bos:
                kw_ids = kw_ids[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(kw_ids))
            self.keyword_ids.append(kw_ids)

    def __call__(self, output_ids: Sequence[int]) -> bool:
        """output_ids: full id sequence (prompt + generated) for ONE sample."""
        gen = list(output_ids[self.prompt_len:])
        if not gen:
            return False
        for kw_ids in self.keyword_ids:
            if len(gen) >= len(kw_ids) and gen[-len(kw_ids):] == list(kw_ids):
                return True
        offset = min(len(gen), self.max_keyword_len)
        text = self.tokenizer.decode(gen[-offset:], skip_special_tokens=True)
        return any(kw in text for kw in self.keywords)
