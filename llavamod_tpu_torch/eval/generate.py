"""Batched VQA-style answer generation front end (port of the parts of
llavamod_tpu/eval/generate.py that the serving path uses).

`VQARunner` renders the conversation template, tokenizes around the
'<image>' placeholders, expands them into image-feature slots (left padded),
and builds the batch as tensors on the model's device.  The host modules
it uses (conversation, mm_utils, data.splice) are the port's own copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from llavamod_tpu_torch import conversation as conv_lib
from llavamod_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from llavamod_tpu_torch.data.splice import expand_image_tokens
from llavamod_tpu_torch.mm_utils import ImagePreprocessor, tokenize_with_images
from llavamod_tpu_torch.models.llava import Llava, LlavaConfig, MultimodalBatch


@dataclasses.dataclass
class VQARunner:
    model: Llava
    tokenizer: Any
    image_preprocessor: ImagePreprocessor
    template_name: str = "qwen"
    max_prompt_len: int = 1024

    @property
    def cfg(self) -> LlavaConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.llm.final_norm.weight.device

    def build_prompt(self, question_text: str, has_image: bool) -> str:
        conv = conv_lib.get_template(self.template_name)
        q = question_text
        if has_image and DEFAULT_IMAGE_TOKEN not in q:
            q = DEFAULT_IMAGE_TOKEN + "\n" + q
        conv.append(conv.roles[0], q)
        conv.append(conv.roles[1], None)
        return conv.render()

    def _encode_batch(self, prompts: List[str],
                      images: List[Optional[np.ndarray]]) -> MultimodalBatch:
        cfg = self.cfg
        n_tok = cfg.num_image_tokens
        spliced = [
            expand_image_tokens(
                tokenize_with_images(p, self.tokenizer), None,
                num_image_tokens=n_tok, max_len=self.max_prompt_len,
                max_images=cfg.max_images, pad_side="left")
            for p in prompts
        ]
        b = len(prompts)
        s = cfg.vision.image_size
        pixels = np.zeros((b, cfg.max_images, 3, s, s), np.float32)
        valid = np.zeros((b, cfg.max_images), bool)
        for i, img in enumerate(images):
            if img is not None:
                m = min(img.shape[0], cfg.max_images)
                pixels[i, :m] = img[:m]
                valid[i, :m] = True
        image_pos = (np.stack([sp.image_slot for sp in spliced])
                     + (np.arange(b) * cfg.max_images * n_tok)[:, None])
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        ids = np.stack([sp.input_ids for sp in spliced])
        return MultimodalBatch(
            input_ids=t(ids, torch.int32),
            segment_ids=t(np.stack([sp.segment for sp in spliced]), torch.int32),
            image_mask=t(np.stack([sp.image_mask for sp in spliced]), torch.bool),
            image_pos=t(image_pos, torch.int32),
            pixels=t(pixels, torch.float32),
            pixel_valid=t(valid, torch.bool),
            labels=t(np.zeros_like(ids), torch.int32))

    def stopping(self, eos_strings: Sequence[str] = ()):
        """(eos_token_ids, stop_sequences): the template's stop string plus
        any extras; multi-token strings become stop sequences."""
        ids = []
        seqs = []
        if getattr(self.tokenizer, "eos_token_id", None) is not None:
            ids.append(self.tokenizer.eos_token_id)
        conv = conv_lib.get_template(self.template_name)
        for s in list(eos_strings) + [conv.stop_str()]:
            if not s:
                continue
            toks = list(self.tokenizer(s).input_ids)
            if len(toks) == 1:
                ids.append(toks[0])
            elif toks:
                seqs.append(tuple(toks))
        return tuple(dict.fromkeys(ids)), tuple(dict.fromkeys(seqs))
