"""Conversation JSON -> (input_ids, labels) preprocessing.

The port's own copy of llavamod_tpu/data/preprocess.py, on the port's
`conversation` and `mm_utils` copies; it gives the same ids and labels
(tests/test_torch_data.py).  Host-side re-implementation of the reference's
`preprocess*` family (data/data_utils.py:102-711).  Behavior parity:

  * preprocess_multimodal_text — clamp '<image>' count to MAX_IMAGE_LENGTH,
    expand '<video>' to num_frames x '<image>', optional <im_start>/<im_end>
    wrapping (data_utils.py:102-151).
  * preprocess_plain — stage-1 captions: prompt is exactly '<image>' +
    caption + sep, with the image span label-masked (data_utils.py:627-650).
  * preprocess_two_style — the SeparatorStyle.TWO family (phi/qwen of
    record, also v1/mistral/minicpm/stablelm/openchat): renders the
    conversation, tokenizes with image splice markers, masks every
    instruction span 'SYSTEM USER: ... ASSISTANT: ' per round, keeping only
    assistant responses (+separator) as labels (data_utils.py:318-394).
    On tokenization-length mismatch the whole sample is masked with a
    warning, exactly like the reference (data_utils.py:383-390).

All functions return python int lists; the static splice/pad happens later
(data/splice.py, data/collator.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from llavamod_tpu_torch import conversation as conv_lib
from llavamod_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    MAX_IMAGE_LENGTH,
    MAX_VIDEO_LENGTH,
)
from llavamod_tpu_torch.mm_utils import tokenize_with_images
from llavamod_tpu_torch.utils.logging import rank0_print


@dataclasses.dataclass
class TokenizedSample:
    input_ids: List[int]
    labels: List[int]


def preprocess_multimodal_text(sources, *, num_frames: int = 8,
                               use_im_start_end: bool = False,
                               keep_video_token: bool = False):
    """Normalize image/video placeholders in conversation text (in place on a
    copied structure).  sources: list of conversations, each a list of
    {'from': 'human'|'gpt', 'value': str}.

    keep_video_token: video-projector mode — '<video>' survives as ONE
    placeholder (tokenized to VIDEO_TOKEN_INDEX, expanded by data/splice.py
    to the projector's token count) instead of the reference's
    num_frames x '<image>' expansion (data_utils.py:125-151)."""
    out = [[dict(turn) for turn in src] for src in sources]
    for src in out:
        for turn in src:
            text = turn["value"]
            if text.startswith(DEFAULT_IMAGE_TOKEN) or text.startswith(DEFAULT_VIDEO_TOKEN):
                n_img = text.count(DEFAULT_IMAGE_TOKEN)
                if n_img > MAX_IMAGE_LENGTH:
                    text = text.replace(DEFAULT_IMAGE_TOKEN * n_img,
                                        DEFAULT_IMAGE_TOKEN * MAX_IMAGE_LENGTH).strip()
                n_vid = text.count(DEFAULT_VIDEO_TOKEN)
                if n_vid > MAX_VIDEO_LENGTH:
                    raise ValueError(f"too many videos in: {text!r}")
            img_rep = DEFAULT_IMAGE_TOKEN
            vid_rep = (DEFAULT_VIDEO_TOKEN if keep_video_token
                       else DEFAULT_IMAGE_TOKEN * num_frames)
            if use_im_start_end:
                img_rep = DEFAULT_IM_START_TOKEN + img_rep + DEFAULT_IM_END_TOKEN
                vid_rep = DEFAULT_IM_START_TOKEN + vid_rep + DEFAULT_IM_END_TOKEN
            text = text.replace(DEFAULT_VIDEO_TOKEN, "\x00VID\x00")
            text = text.replace(DEFAULT_IMAGE_TOKEN, img_rep)
            text = text.replace("\x00VID\x00", vid_rep)
            turn["value"] = text
    return out


def preprocess_plain(sources, tokenizer,
                     template: Optional[conv_lib.Conversation] = None) -> TokenizedSample:
    """Stage-1 adaptor pretraining: one (image, caption) pair per sample."""
    template = template or conv_lib.get_template("plain")
    src = sources[0] if isinstance(sources[0], list) else sources
    assert len(src) == 2, "plain preprocessing expects exactly 2 turns"
    assert DEFAULT_IMAGE_TOKEN in src[0]["value"]
    prompt_part = DEFAULT_IMAGE_TOKEN
    text = prompt_part + src[1]["value"] + template.sep
    ids = tokenize_with_images(text, tokenizer)
    labels = list(ids)
    masked = len(tokenize_with_images(prompt_part, tokenizer))
    labels[:masked] = [IGNORE_INDEX] * masked
    return TokenizedSample(ids, labels)


def _render_from_template(sources, template: conv_lib.Conversation):
    """Role-normalized prompt rendering shared by every style
    (the apply-prompt-templates loop each reference variant repeats,
    e.g. data_utils.py:327-337)."""
    conv = template.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    src = sources[0] if (sources and isinstance(sources[0], list)) else sources
    if roles.get(src[0]["from"]) != conv.roles[0]:
        src = src[1:]  # skip a leading non-human turn
    conv.messages = []
    for j, turn in enumerate(src):
        role = roles[turn["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        conv.append(role, turn["value"])
    return conv, conv.render()


def _mask_rounds(prompt: str, rounds: Sequence[str], sep: str, tokenizer, *,
                 cur0: int, instr_offset: int, round_extra: int,
                 model_max_length: int) -> TokenizedSample:
    """Shared per-round instruction-masking engine.

    Parameterizes the arithmetic that differs across the reference's
    preprocess_{phi,v1,openchat,llama_2,gemma_2,mpt} family:
      cur0          initial cursor (1 skips a BOS token)
      instr_offset  added to the tokenized instruction length
      round_extra   added to each round's tokenized length (e.g. +1 for the
                    eos the split removed, data_utils.py:371)
    On total-length mismatch the whole sample is masked with a warning,
    exactly like the reference (data_utils.py:383-390)."""
    ids = tokenize_with_images(prompt, tokenizer)
    labels = list(ids)
    total = len(ids)
    cur = cur0
    labels[:cur] = [IGNORE_INDEX] * cur
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        instruction = parts[0] + sep
        round_len = len(tokenize_with_images(rou, tokenizer)) + round_extra
        instruction_len = (len(tokenize_with_images(instruction, tokenizer))
                           + instr_offset)
        n = min(max(instruction_len, 0), max(0, len(labels) - cur))
        labels[cur:cur + n] = [IGNORE_INDEX] * n
        cur += round_len
    labels[cur:] = [IGNORE_INDEX] * max(0, len(labels) - cur)

    if cur < model_max_length and cur != total:
        labels = [IGNORE_INDEX] * len(labels)
        rank0_print(f"WARNING: tokenization mismatch: {cur} vs. {total}. (ignored)")
    return TokenizedSample(ids, labels)


def preprocess_two_style(sources, tokenizer,
                         template: conv_lib.Conversation,
                         *, extra_round_tokens: Optional[int] = None,
                         model_max_length: int = 1 << 30) -> TokenizedSample:
    """preprocess_phi equivalent (qwen/phi/stablelm, data_utils.py:318-394).

    extra_round_tokens: how many tokens the sep2 separator contributes that
    splitting removes.  The reference hardcodes +1 ("for eos_token",
    data_utils.py:371) because Qwen's <|endoftext|> is one token; we derive
    it from the tokenizer so non-single-token separators mask correctly.
    """
    if extra_round_tokens is None:
        sep2_ids = tokenizer(template.sep2).input_ids
        bos = getattr(tokenizer, "bos_token_id", None)
        if sep2_ids and bos is not None and sep2_ids[0] == bos:
            sep2_ids = sep2_ids[1:]
        extra_round_tokens = len(sep2_ids)
    conv, prompt = _render_from_template(sources, template)
    return _mask_rounds(
        prompt, prompt.split(conv.sep2), conv.sep + conv.roles[1] + ": ",
        tokenizer, cur0=0, instr_offset=-1, round_extra=extra_round_tokens,
        model_max_length=model_max_length)


# alias documenting the reference name
preprocess_phi = preprocess_two_style


def preprocess_v1(sources, tokenizer, template: conv_lib.Conversation,
                  *, model_max_length: int = 1 << 30) -> TokenizedSample:
    """v1/vicuna masking (data_utils.py:236-315); also openchat/mistral/
    minicpm (data_utils.py:395-474 — identical arithmetic).  Assumes a
    BOS-prepending tokenizer: cursor starts after BOS and each round's own
    BOS stands in for the sep2 token the split removed."""
    conv, prompt = _render_from_template(sources, template)
    return _mask_rounds(
        prompt, prompt.split(conv.sep2), conv.sep + conv.roles[1] + ": ",
        tokenizer, cur0=1, instr_offset=-2, round_extra=0,
        model_max_length=model_max_length)


preprocess_openchat = preprocess_v1


def preprocess_llama_2(sources, tokenizer, template: conv_lib.Conversation,
                       *, model_max_length: int = 1 << 30) -> TokenizedSample:
    """LLAMA_2 [INST] masking (data_utils.py:156-233)."""
    conv, prompt = _render_from_template(sources, template)
    return _mask_rounds(
        prompt, prompt.split(conv.sep2), "[/INST] ",
        tokenizer, cur0=1, instr_offset=-2, round_extra=0,
        model_max_length=model_max_length)


def preprocess_gemma_2(sources, tokenizer, template: conv_lib.Conversation,
                       *, model_max_length: int = 1 << 30) -> TokenizedSample:
    """GEMMA_2 <start_of_turn> masking (data_utils.py:545-624)."""
    conv, prompt = _render_from_template(sources, template)
    sep = "<start_of_turn>" + conv.sep + conv.roles[1] + "\n"
    return _mask_rounds(
        prompt, prompt.split(conv.sep2), sep,
        tokenizer, cur0=1, instr_offset=-1, round_extra=0,
        model_max_length=model_max_length)


def preprocess_mpt(sources, tokenizer, template: conv_lib.Conversation,
                   *, model_max_length: int = 1 << 30) -> TokenizedSample:
    """MPT im_start/im_end masking (data_utils.py:478-542): rounds are
    regrouped as [system+user+gpt, user+gpt, ...] on conv.sep."""
    conv, prompt = _render_from_template(sources, template)
    rounds = prompt.split(conv.sep)
    re_rounds = [conv.sep.join(rounds[:3])]
    for idx in range(3, len(rounds), 2):
        re_rounds.append(conv.sep.join(rounds[idx:idx + 2]))
    sep_tokens = len(tokenize_with_images(conv.sep, tokenizer))
    return _mask_rounds(
        prompt, re_rounds, conv.sep + conv.roles[1],
        tokenizer, cur0=0, instr_offset=0, round_extra=sep_tokens,
        model_max_length=model_max_length)


def preprocess_default(sources, tokenizer, template: conv_lib.Conversation,
                       *, model_max_length: int = 1 << 30) -> TokenizedSample:
    """Legacy v0 '### speaker: ...' masking (data_utils.py:686-713 fallback
    + _add_speaker_and_signal/_mask_targets, data_utils.py:70-99)."""
    begin, end = "### ", "\n"
    src = sources[0] if (sources and isinstance(sources[0], list)) else sources
    header = f"{template.system}\n\n"
    role_names = {"human": template.roles[0], "gpt": template.roles[1]}
    pieces = [header]
    speakers = []
    for turn in src:
        name = role_names.get(turn["from"], "unknown")
        pieces.append(begin + name + ": " + turn["value"] + end)
        speakers.append(turn["from"])
    prompt = "".join(pieces) + begin

    ids = tokenize_with_images(prompt, tokenizer)
    labels = list(ids)
    lens = [len(tokenize_with_images(p, tokenizer)) for p in pieces]
    cur = lens[0]
    labels[:cur] = [IGNORE_INDEX] * cur
    for tokenized_len, speaker in zip(lens[1:], speakers):
        if speaker == "human":
            n = max(0, min(tokenized_len - 2, len(labels) - cur - 2))
            labels[cur + 2:cur + 2 + n] = [IGNORE_INDEX] * n
        cur += tokenized_len
    return TokenizedSample(ids, labels)


def preprocess_conversations(sources, tokenizer,
                             template_name: str = "qwen",
                             model_max_length: int = 1 << 30) -> TokenizedSample:
    """Dispatch on the conversation template's version (reference
    preprocess, data_utils.py:653-686)."""
    template = conv_lib.get_template(template_name)
    kw = dict(model_max_length=model_max_length)
    v = template.version
    if template.style is conv_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer, template)
    if template.style is conv_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, template, **kw)
    if v.startswith(("phi", "qwen", "stablelm")):
        return preprocess_two_style(sources, tokenizer, template, **kw)
    if v.startswith(("openchat", "mistral", "minicpm", "v1")):
        return preprocess_v1(sources, tokenizer, template, **kw)
    if v == "mpt" or template.style is conv_lib.SeparatorStyle.MPT:
        return preprocess_mpt(sources, tokenizer, template, **kw)
    if v.startswith(("gemma", "gemma_2")):
        return preprocess_gemma_2(sources, tokenizer, template, **kw)
    if template.style is conv_lib.SeparatorStyle.TWO:
        return preprocess_two_style(sources, tokenizer, template, **kw)
    return preprocess_default(sources, tokenizer, template, **kw)
