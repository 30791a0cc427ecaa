"""The token sequences the reference scores, worked out from the raw
conversations and questions: LLaVA's "qwen" chat template (the phi
template of the upstream conversation.py, SeparatorStyle.TWO), the
upstream `preprocess_phi` label masking, and the splice of one image's
feature rows at its '<image>' placeholder.  Plain Python; the tokenizer is
the benchmark's (benchmark/harness/tokenizer.py), handed to both sides.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

IGNORE = -100
IMAGE = -200
SYSTEM = ("A chat between a curious user and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the user's questions.")
ROLES = ("USER", "ASSISTANT")
SEP, SEP2 = " ", "<|endoftext|>"


def render(messages: Sequence[Tuple[str, str]]) -> str:
    """The TWO-style prompt: system, then 'ROLE: text' closed by the
    separators in turn; an empty last message opens the reply."""
    out = SYSTEM + SEP
    for i, (role, text) in enumerate(messages):
        out += f"{role}: {text}{(SEP, SEP2)[i % 2]}" if text else f"{role}:"
    return out


def tokenize(text: str, tok) -> List[int]:
    """Ids with IMAGE at each '<image>' (no BOS: the stand-in has none)."""
    parts = text.split("<image>")
    ids = list(tok.encode(parts[0]))
    for part in parts[1:]:
        ids.append(IMAGE)
        ids += tok.encode(part)
    return ids


def question_prompt(question: str) -> str:
    """The serving prompt of one image question (the server's handler)."""
    return render([(ROLES[0], "<image>\n" + question), (ROLES[1], "")])


def conversation_ids(turns: Sequence[dict], tok) -> Tuple[List[int], List[int]]:
    """(ids, labels) of a training conversation, the image still one
    IMAGE id: upstream preprocess_phi.  The rounds are the prompt split at
    SEP2; in each, the instruction (up to and with ' ASSISTANT: ') less one
    token is masked, and each round counts the SEP2 tokens the split
    removed."""
    messages = [(ROLES[0] if t["from"] == "human" else ROLES[1], t["value"])
                for t in turns]
    prompt = render(messages)
    ids = tokenize(prompt, tok)
    labels = list(ids)
    sep = SEP + ROLES[1] + ": "
    extra = len(tok.encode(SEP2))
    cur = 0
    for rou in prompt.split(SEP2):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        round_len = len(tokenize(rou, tok)) + extra
        instr = len(tokenize(parts[0] + sep, tok)) - 1
        n = min(max(instr, 0), max(0, len(labels) - cur))
        labels[cur:cur + n] = [IGNORE] * n
        cur += round_len
    labels[cur:] = [IGNORE] * max(0, len(labels) - cur)
    if cur != len(ids):
        labels = [IGNORE] * len(labels)
    return ids, labels


def splice(ids: Sequence[int], labels: Sequence[int], n_image: int,
           max_len: int) -> Tuple[List[int], List[int], int]:
    """(ids, labels, image start): the IMAGE id expanded to `n_image`
    feature rows (id 0, label IGNORE), cut to `max_len`."""
    out_ids, out_lab, start = [], [], -1
    for t, lab in zip(ids, labels):
        if t == IMAGE:
            start = len(out_ids)
            out_ids += [0] * n_image
            out_lab += [IGNORE] * n_image
        else:
            out_ids.append(t)
            out_lab.append(lab)
    return out_ids[:max_len], out_lab[:max_len], start
