"""Conversation templates: prompt rendering for every supported chat format.

Rendered prompts are byte-identical to the reference's
`llavamod/conversation.py` templates (styles at conversation.py:31-123,
registry at conversation.py:452-476) so tokenization — and therefore label
masking — is interchangeable.  The structure here is different: each
separator style is a standalone renderer function registered in
`_RENDERERS`, and templates are immutable; `Conversation.copy()` returns a
fresh mutable message list.

The port's own copy of llavamod_tpu/conversation.py.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"
    MPT = "mpt"
    PLAIN = "plain"
    LLAMA_2 = "llama_2"
    GEMMA_2 = "gemma_2"


Message = List  # [role, text_or_None]


def _render_single(c: "Conversation", messages: Sequence[Message]) -> str:
    out = c.system + c.sep
    for role, text in messages:
        if text:
            out += f"{role}: {text}{c.sep}"
        else:
            out += f"{role}:"
    return out


def _render_two(c: "Conversation", messages: Sequence[Message]) -> str:
    seps = (c.sep, c.sep2)
    out = c.system + seps[0]
    for i, (role, text) in enumerate(messages):
        if text:
            out += f"{role}: {text}{seps[i % 2]}"
        else:
            out += f"{role}:"
    return out


def _render_mpt(c: "Conversation", messages: Sequence[Message]) -> str:
    out = c.system + c.sep
    for role, text in messages:
        out += role + (text + c.sep if text else "")
    return out


def _render_plain(c: "Conversation", messages: Sequence[Message]) -> str:
    seps = (c.sep, c.sep2)
    out = c.system
    for i, (_, text) in enumerate(messages):
        if text:
            out += text + seps[i % 2]
    return out


def _render_llama2(c: "Conversation", messages: Sequence[Message]) -> str:
    wrap_sys = lambda s: f"<<SYS>>\n{s}\n<</SYS>>\n\n"  # noqa: E731
    out = ""
    for i, (role, text) in enumerate(messages):
        if not text:
            continue
        if i == 0:
            text = wrap_sys(c.system) + text
        if i % 2 == 0:
            out += f"{c.sep}[INST] {text} [/INST]"
        else:
            out += f" {text} {c.sep2}"
    return out.lstrip(c.sep)


def _render_gemma2(c: "Conversation", messages: Sequence[Message]) -> str:
    seps = (c.sep, c.sep2)
    out = c.system + seps[0]
    for i, (role, text) in enumerate(messages):
        if text:
            out += f"<start_of_turn>{role}\n{text}<end_of_turn>\n{seps[i % 2]}"
        else:
            out += f"<start_of_turn>{role}\n"
    return out


_RENDERERS: Dict[SeparatorStyle, Callable] = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: _render_llama2,
    SeparatorStyle.GEMMA_2: _render_gemma2,
}


@dataclasses.dataclass
class Conversation:
    """A chat template plus an in-progress message transcript."""

    system: str
    roles: Tuple[str, str]
    style: SeparatorStyle
    sep: str
    sep2: str = ""
    version: str = "unknown"
    messages: List[Message] = dataclasses.field(default_factory=list)
    offset: int = 0

    def append(self, role: str, text: Optional[str]) -> None:
        self.messages.append([role, text])

    # Alias matching the reference public API (conversation.py:125).
    append_message = append

    def _front_image_fixup(self) -> List[Message]:
        """If the first user message carries an image, normalize it so the
        '<image>' placeholder leads the text (reference conversation.py:33-42).
        mmtag variants wrap the image in an <Image>..</Image> pseudo-turn."""
        msgs = [list(m) for m in self.messages]
        if msgs and isinstance(msgs[0][1], tuple):
            role, payload = msgs[0]
            text = payload[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                msgs[0] = [role, text]
                msgs.insert(0, [self.roles[0], "<Image><image></Image>"])
                msgs.insert(1, [self.roles[1], "Received."])
            else:
                msgs[0] = [role, "<image>\n" + text]
        # Flatten any remaining tuple payloads to their text component.
        for m in msgs:
            if isinstance(m[1], tuple):
                m[1] = m[1][0]
        return msgs

    def render(self) -> str:
        return _RENDERERS[self.style](self, self._front_image_fixup())

    # Alias matching the reference public API (conversation.py:31).
    get_prompt = render

    def stop_str(self) -> str:
        """Generation stop string: sep2 for TWO/GEMMA_2 styles, sep otherwise
        (the dispatch every reference generator repeats, e.g.
        model_vqa_mmbench.py:131-137)."""
        if self.style in (SeparatorStyle.TWO, SeparatorStyle.GEMMA_2):
            return self.sep2
        return self.sep

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            style=self.style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
            messages=[list(m) for m in self.messages],
            offset=self.offset,
        )

    def to_dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [[r, t] for r, t in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_ASSISTANT_DEFAULT_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)

_HUMAN_DEFAULT_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)

_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)


def _two(version: str, sep2: str, system: str = _ASSISTANT_DEFAULT_SYSTEM,
         roles=("USER", "ASSISTANT")) -> Conversation:
    return Conversation(system=system, roles=roles, style=SeparatorStyle.TWO,
                        sep=" ", sep2=sep2, version=version)


# Registry of templates (values mirror reference conversation.py:240-476).
# "qwen" maps to the phi template — the recipe of record (conversation.py:460).
conv_templates: Dict[str, Conversation] = {}


def register_template(name: str, conv: Conversation) -> Conversation:
    conv_templates[name] = conv
    return conv


conv_phi = register_template("phi", _two("phi", "<|endoftext|>"))
register_template("qwen", conv_phi)
conv_vicuna_v1 = register_template("v1", _two("v1", "</s>"))
register_template("vicuna_v1", conv_vicuna_v1)
register_template("mistral", _two("mistral", "</s>"))
register_template("openchat", _two("openchat", "<|end_of_turn|>"))
register_template("minicpm", _two("minicpm", "</s>"))
register_template("stablelm", _two("stablelm", "<|endoftext|>"))

conv_vicuna_v0 = register_template(
    "v0",
    Conversation(system=_HUMAN_DEFAULT_SYSTEM, roles=("Human", "Assistant"),
                 style=SeparatorStyle.SINGLE, sep="###", version="v0"),
)
register_template("default", conv_vicuna_v0)

register_template(
    "llama_2",
    Conversation(
        system=(
            "You are a helpful, respectful and honest assistant. Always answer as "
            "helpfully as possible, while being safe.  Your answers should not include "
            "any harmful, unethical, racist, sexist, toxic, dangerous, or illegal "
            "content. Please ensure that your responses are socially unbiased and "
            "positive in nature.\n\nIf a question does not make any sense, or is not "
            "factually coherent, explain why instead of answering something not "
            "correct. If you don't know the answer to a question, please don't share "
            "false information."
        ),
        roles=("USER", "ASSISTANT"), style=SeparatorStyle.LLAMA_2,
        sep="<s>", sep2="</s>", version="llama_v2"),
)

register_template(
    "llava_llama_2",
    Conversation(
        system=("You are a helpful language and vision assistant. "
                "You are able to understand the visual content that the user provides, "
                "and assist the user with a variety of tasks using natural language."),
        roles=("USER", "ASSISTANT"), style=SeparatorStyle.LLAMA_2,
        sep="<s>", sep2="</s>", version="llama_v2"),
)

register_template(
    "gemma_2",
    Conversation(system="", roles=("user", "model"), style=SeparatorStyle.GEMMA_2,
                 sep="", sep2="<eos>", version="gemma_2"),
)

register_template(
    "mpt",
    Conversation(
        system=("<|im_start|>system\nA conversation between a user and an LLM-based "
                "AI assistant. The assistant gives helpful and honest answers."),
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
        style=SeparatorStyle.MPT, sep="<|im_end|>", version="mpt"),
)

conv_plain = register_template(
    "plain",
    Conversation(system="", roles=("", ""), style=SeparatorStyle.PLAIN,
                 sep="\n", version="plain"),
)
register_template("v0_plain", conv_plain)

register_template(
    "llava_v0",
    Conversation(system=_HUMAN_DEFAULT_SYSTEM, roles=("Human", "Assistant"),
                 style=SeparatorStyle.SINGLE, sep="###", version="llava_v0"),
)
register_template(
    "v0_mmtag",
    Conversation(system=_MMTAG_SYSTEM, roles=("Human", "Assistant"),
                 style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag"),
)
register_template(
    "llava_v1",
    Conversation(system=_HUMAN_DEFAULT_SYSTEM, roles=("USER", "ASSISTANT"),
                 style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1"),
)
register_template(
    "v1_mmtag",
    Conversation(system=_MMTAG_SYSTEM, roles=("USER", "ASSISTANT"),
                 style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1_mmtag"),
)

default_conversation = conv_vicuna_v1


def get_template(name: str) -> Conversation:
    """Fetch a fresh copy of a registered template by name."""
    return conv_templates[name].copy()


def infer_template_name(model_name: str) -> str:
    """Pick a conversation template from a model/checkpoint name.

    Mirrors the dispatch in reference `serve/cli.py:33-49` but as an explicit
    ordered rule list rather than inline if-chains.
    """
    lowered = model_name.lower()
    rules = [
        ("plain-", "plain"),
        ("qwen", "qwen"),
        ("phi", "phi"),
        ("stablelm", "stablelm"),
        ("minicpm", "minicpm"),
        ("openchat", "openchat"),
        ("mistral", "mistral"),
        ("gemma", "gemma_2"),
        ("llama-2", "llava_llama_2"),
        ("mpt", "mpt"),
        ("v1", "llava_v1"),
        ("v0", "llava_v0"),
    ]
    for needle, template in rules:
        if needle in lowered:
            return template
    return "v1"
