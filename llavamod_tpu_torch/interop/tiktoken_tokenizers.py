"""Self-contained tiktoken-backed tokenizers for the two reference LLM
families whose tokenizers transformers does not ship: qwen-1.0 and
stablelm's arcade100k (a copy of llavamod_tpu/interop/tiktoken_tokenizers.py
with one repair, below).  The classes are transformers tokenizers, so the
port imports this module only where it loads a tokenizer
(`train/run.py::load_tokenizer`, `models/builder.py::load_pretrained_model`),
and `tiktoken` only where an encoding is built.

The reference vendors one full PreTrainedTokenizer implementation per
family (the reference's llavamod/model/language_model/qwen/tokenization_qwen.py,
.../stablelm/tokenization_arcade100k.py:1-275) and loads them via
trust_remote_code artifacts shipped beside the checkpoint.  Here both
collapse into ONE engine parameterized by a `TiktokenSpec` (they differ
only in their special-token tables and vocab file names — the BPE split
pattern is the same cl100k-style regex).  Given the checkpoint's
``*.tiktoken`` vocab file, end-to-end text processing needs no external
trusted code.

Semantics kept from the reference implementations:
  * NFC-normalize before encoding; special tokens allowed in plain text
    by default (``allowed_special="all"``).
  * tokens are the raw byte sequences (``bytes``) for BPE entries and
    ``str`` for specials; ``convert_tokens_to_string`` stitches byte runs
    back with the configured ``errors`` policy.
  * ``skip_special_tokens`` drops every id >= the end-of-text id (both
    references place all specials at the top of the id space).
  * adding tokens is only allowed for surface forms already in the
    special table (vocabulary is closed).

The repair: the JAX copy sets eos and pad only for arcade100k, so a qwen-1.0
tokenizer there has no eos_token_id and pad id 0.  Here both families set
eos and pad to <|endoftext|> (`eod_id`), which the reference's qwen
tokenizer gives generation as its end-of-text token.
"""

from __future__ import annotations

import base64
import os
import unicodedata
from dataclasses import dataclass, field
from typing import Collection, Dict, List, Mapping, Optional, Set, Tuple, Union

from transformers import AddedToken, PreTrainedTokenizer

# the cl100k-style split pattern both families use
_PAT_STR = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"""
            r"""|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")

ENDOFTEXT = "<|endoftext|>"


def _qwen_special_tokens() -> Dict[str, int]:
    """<|endoftext|>/<|im_start|>/<|im_end|> + 205 <|extra_i|> slots from
    id 151643 (tokenization_qwen.py:23-45).  <|extra_0|> is the reference's
    injected unk/pad token (reference train/train.py:365-385)."""
    names = [ENDOFTEXT, "<|im_start|>", "<|im_end|>"]
    names += [f"<|extra_{i}|>" for i in range(205)]
    return {t: 151643 + i for i, t in enumerate(names)}


def _arcade100k_special_tokens() -> Dict[str, int]:
    """StarCoder/FIM/chat/pause/register specials from id 100257
    (tokenization_arcade100k.py:32-76)."""
    names = [ENDOFTEXT]
    names += [f"<|fim_{k}|>" for k in ("prefix", "middle", "suffix", "pad")]
    names += ["<gh_stars>", "<filename>", "<issue_start>", "<issue_comment>",
              "<issue_closed>", "<jupyter_start>", "<jupyter_text>",
              "<jupyter_code>", "<jupyter_output>", "<empty_output>",
              "<commit_before>", "<commit_msg>", "<commit_after>",
              "<reponame>"]
    names += ["<|endofprompt|>", "<|im_start|>", "<|im_end|>", "<|pause|>"]
    names += [f"<|reg{i}|>" for i in range(8)]
    names += ["<|extra0|>"]
    return {t: 100257 + i for i, t in enumerate(names)}


@dataclass(frozen=True)
class TiktokenSpec:
    name: str
    vocab_file_name: str
    special_tokens: Mapping[str, int] = field(default_factory=dict)


QWEN_V1_SPEC = TiktokenSpec(
    name="qwen-v1", vocab_file_name="qwen.tiktoken",
    special_tokens=_qwen_special_tokens())
ARCADE100K_SPEC = TiktokenSpec(
    name="arcade100k", vocab_file_name="arcade100k.tiktoken",
    special_tokens=_arcade100k_special_tokens())


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Parse a .tiktoken vocab file (base64 token + rank per line)."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as fh:
        for line in fh.read().splitlines():
            if line:
                token, rank = line.split()
                ranks[base64.b64decode(token)] = int(rank)
    return ranks


class TiktokenTokenizer(PreTrainedTokenizer):
    """One engine for every tiktoken-vocab family; subclass sets `spec`."""

    spec: TiktokenSpec

    def __init__(self, vocab_file: str, errors: str = "replace", **kwargs):
        import tiktoken

        super().__init__(errors=errors, **kwargs)
        self.errors = errors
        self.mergeable_ranks = load_tiktoken_ranks(vocab_file)
        self.special_tokens = dict(self.spec.special_tokens)
        self._tok = tiktoken.Encoding(
            self.spec.name, pat_str=_PAT_STR,
            mergeable_ranks=self.mergeable_ranks,
            special_tokens=self.special_tokens)
        self.decoder: Dict[int, Union[bytes, str]] = {
            v: k for k, v in self.mergeable_ranks.items()}
        self.decoder.update({v: k for k, v in self.special_tokens.items()})
        self.eod_id = self._tok.eot_token
        if "<|im_start|>" in self.special_tokens:
            self.im_start_id = self.special_tokens["<|im_start|>"]
            self.im_end_id = self.special_tokens["<|im_end|>"]
        self.eos_token = ENDOFTEXT
        self.pad_token = ENDOFTEXT

    # -- vocab surface ----------------------------------------------------
    def __len__(self) -> int:
        return self._tok.n_vocab

    @property
    def vocab_size(self) -> int:
        return self._tok.n_vocab

    def get_vocab(self) -> Dict[bytes, int]:
        return self.mergeable_ranks

    def save_vocabulary(self, save_directory: str, **kwargs) -> Tuple[str]:
        path = os.path.join(save_directory, self.spec.vocab_file_name)
        with open(path, "w", encoding="utf8") as fh:
            for k, v in self.mergeable_ranks.items():
                fh.write(base64.b64encode(k).decode("utf8") + f" {v}\n")
        return (path,)

    # -- pickling (the tiktoken Encoding is not picklable) ----------------
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_tok"]
        return state

    def __setstate__(self, state):
        import tiktoken

        self.__dict__.update(state)
        self._tok = tiktoken.Encoding(
            self.spec.name, pat_str=_PAT_STR,
            mergeable_ranks=self.mergeable_ranks,
            special_tokens=self.special_tokens)

    # -- encode/decode ----------------------------------------------------
    def tokenize(self, text: str,
                 allowed_special: Union[Set, str] = "all",
                 disallowed_special: Union[Collection, str] = (),
                 **kwargs) -> List[Union[bytes, str]]:
        text = unicodedata.normalize("NFC", text)
        return [self.decoder[t] for t in self._tok.encode(
            text, allowed_special=allowed_special,
            disallowed_special=disallowed_special)]

    def convert_tokens_to_ids(
            self, tokens: Union[bytes, str, List[Union[bytes, str]]]):
        if isinstance(tokens, (str, bytes)):
            return self._convert_single(tokens)
        return [self._convert_single(t) for t in tokens]

    def _convert_single(self, token: Union[bytes, str]) -> Optional[int]:
        if token in self.special_tokens:
            return self.special_tokens[token]
        return self.mergeable_ranks.get(token)

    def _convert_token_to_id(self, token: Union[bytes, str]) -> int:
        out = self._convert_single(token)
        if out is None:
            raise ValueError(f"unknown token {token!r}")
        return out

    def _convert_id_to_token(self, index: int) -> Union[bytes, str]:
        if index in self.decoder:
            return self.decoder[index]
        raise ValueError("unknown ids")

    def convert_tokens_to_string(self,
                                 tokens: List[Union[bytes, str]]) -> str:
        parts: List[str] = []
        pending = b""
        for t in tokens:
            if isinstance(t, str):
                if pending:
                    parts.append(pending.decode("utf-8", errors=self.errors))
                    pending = b""
                parts.append(t)
            elif isinstance(t, bytes):
                pending += t
            else:
                raise TypeError(f"token of unsupported type {type(t)}")
        if pending:
            parts.append(pending.decode("utf-8", errors=self.errors))
        return "".join(parts)

    def _decode(self, token_ids: Union[int, List[int]],
                skip_special_tokens: bool = False,
                errors: Optional[str] = None, **kwargs) -> str:
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        if skip_special_tokens:
            # all specials sit at/above the end-of-text id in both families
            token_ids = [i for i in token_ids if i < self.eod_id]
        return self._tok.decode(token_ids, errors=errors or self.errors)

    def _add_tokens(self, new_tokens, special_tokens: bool = False) -> int:
        if not special_tokens and new_tokens:
            raise ValueError("Adding regular tokens is not supported")
        for token in new_tokens:
            surface = token.content if isinstance(token, AddedToken) else token
            if surface not in self.special_tokens:
                raise ValueError(
                    "Adding unknown special tokens is not supported")
        return 0

    def _tokenize(self, text: str, **kwargs):
        raise NotImplementedError  # `tokenize` is overridden wholesale


class QWenV1Tokenizer(TiktokenTokenizer):
    """qwen-1.0 (tokenization_qwen.py semantics)."""

    spec = QWEN_V1_SPEC
    vocab_files_names = {"vocab_file": QWEN_V1_SPEC.vocab_file_name}


class Arcade100kTokenizer(TiktokenTokenizer):
    """stablelm arcade100k (tokenization_arcade100k.py semantics)."""

    spec = ARCADE100K_SPEC
    vocab_files_names = {"vocab_file": ARCADE100K_SPEC.vocab_file_name}
    model_input_names = ["input_ids", "attention_mask"]


def load_tiktoken_tokenizer(path: str) -> Optional[TiktokenTokenizer]:
    """Return the right tiktoken tokenizer when `path` is a directory
    carrying one of the known vocab files, else None (callers fall back to
    AutoTokenizer).  This removes the trust_remote_code dependency for the
    qwen-1.0 and stablelm families."""
    if not os.path.isdir(path):
        return None
    for cls in (QWenV1Tokenizer, Arcade100kTokenizer):
        vf = os.path.join(path, cls.spec.vocab_file_name)
        if os.path.exists(vf):
            return cls(vf)
    return None
