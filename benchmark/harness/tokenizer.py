"""A deterministic character-level stand-in for the Qwen tokenizer: the
card's machine has no tokenizer files and no network.

Every character of a text is one id below Qwen's 151,646 regular ids
(`QWEN_REGULAR_IDS`), no BOS and no EOS, pad id 0, so the per-round label
masking of the training data lines up exactly.  `decode` writes every id
as `<id>`, so a served answer's text gives back its ids exactly
(`ids_of`).  The reference (benchmark/reference) tokenizes with this same
class: it is part of the inputs the benchmark hands to both sides.
"""

from __future__ import annotations

import re
import types
from typing import List, Sequence

QWEN_REGULAR_IDS = 151646
_ID = re.compile(r"<(\d+)>")


def char_id(c: str) -> int:
    return 10 + (ord(c) * 7919) % (QWEN_REGULAR_IDS - 10)


class StandInTokenizer:
    pad_token_id = 0
    bos_token_id = None
    eos_token_id = None

    def encode(self, text: str) -> List[int]:
        return [char_id(c) for c in text]

    def __call__(self, text: str):
        return types.SimpleNamespace(input_ids=self.encode(text))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        return "".join(f"<{int(i)}>" for i in ids)

    def add_tokens(self, tokens, special_tokens=False) -> int:
        return 0


def ids_of(text: str) -> List[int]:
    """The ids of a text that `StandInTokenizer.decode` wrote."""
    return [int(m) for m in _ID.findall(text)]
