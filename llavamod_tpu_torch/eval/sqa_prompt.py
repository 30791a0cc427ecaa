"""ScienceQA base-prompt builder (few-shot CoT prompt formats).

Functional port of the reference's
scripts/convert_sqa_to_llava_base_prompt.py:1-333, whose three
near-identical example builders (create_one_example / _chatbot / _gpt4,
lines 41-222) collapse into ONE template table + per-style cleanup.
Byte parity with all three reference variants across every
input/output format is pinned by
tests/test_sqa_prompt.py (the reference file itself is the oracle).

Formats: "<INPUT>-<OUTPUT>" where INPUT selects the field order
(CQM/QCM/QCML/QCME/QCMLE/QCLM/QCEM/QCLEM) and OUTPUT the answer
rationale layout (A/AL/AE/ALE/AEL/LA/EA/LEA/ELA, + LEPA chatbot-only).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

DEFAULT_OPTIONS = ("A", "B", "C", "D", "E")

# reference lines 45-64 (identical across the three variants)
_INPUT_TEMPLATES = {
    "CQM": "Context: {context}\nQuestion: {question}\nOptions: {choice}\n",
    "QCM": "Question: {question}\nContext: {context}\nOptions: {choice}\n",
    "QCML": ("Question: {question}\nContext: {context}\n"
             "Options: {choice}\nBECAUSE: {lecture}\n"),
    "QCME": ("Question: {question}\nContext: {context}\n"
             "Options: {choice}\nBECAUSE: {solution}\n"),
    "QCMLE": ("Question: {question}\nContext: {context}\n"
              "Options: {choice}\nBECAUSE: {lecture} {solution}\n"),
    "QCLM": ("Question: {question}\nContext: {context}\n"
             "BECAUSE: {lecture}\nOptions: {choice}\n"),
    "QCEM": ("Question: {question}\nContext: {context}\n"
             "BECAUSE: {solution}\nOptions: {choice}\n"),
    "QCLEM": ("Question: {question}\nContext: {context}\n"
              "BECAUSE: {lecture} {solution}\nOptions: {choice}\n"),
}

# reference lines 66-96 (identical across variants; LEPA chatbot-only)
_OUTPUT_TEMPLATES = {
    "A": "Answer: The answer is {answer}.",
    "AL": "Answer: The answer is {answer}. BECAUSE: {solution}",
    "AE": "Answer: The answer is {answer}. BECAUSE: {lecture}",
    "ALE": "Answer: The answer is {answer}. BECAUSE: {lecture} {solution}",
    "AEL": "Answer: The answer is {answer}. BECAUSE: {solution} {lecture}",
    "LA": "Answer: {lecture} The answer is {answer}.",
    "EA": "Answer: {solution} The answer is {answer}.",
    "LEA": "Answer: {lecture} {solution} The answer is {answer}.",
    "ELA": "Answer: {solution} {lecture} The answer is {answer}.",
}


def problem_fields(problem: dict, use_caption: bool,
                   options: Sequence[str] = DEFAULT_OPTIONS,
                   escape_newlines: bool = True) -> Dict[str, str]:
    """question/context/choice/answer/lecture/solution of one problem
    (reference get_*_text, lines 1-38).  escape_newlines mirrors the
    \\n-escaping of lecture/solution ("GPT-3 can generate the lecture
    with more tokens"); the chatbot builder re-unescapes (line 240)."""
    context = " ".join([problem["hint"],
                        problem["caption"] if use_caption else ""]).strip()
    esc = (lambda s: s.replace("\n", "\\n")) if escape_newlines else \
        (lambda s: s)
    return {
        "question": problem["question"],
        "context": context or "N/A",
        "choice": " ".join(f"({options[i]}) {c}"
                           for i, c in enumerate(problem["choices"])),
        "answer": options[problem["answer"]],
        "lecture": esc(problem["lecture"]),
        "solution": esc(problem["solution"]),
    }


def _render(prompt_format: str, fields: Dict[str, str], test_example: bool,
            allow_lepa: bool) -> Tuple[str, str]:
    input_format, output_format = prompt_format.split("-")
    inp = _INPUT_TEMPLATES[input_format].format(**fields)
    if test_example:
        out = "Answer:"
    elif output_format == "LEPA":
        if not allow_lepa:
            raise KeyError("LEPA is a chatbot-only output format "
                           "(reference create_one_example_chatbot:88-96)")
        out = ""
        if fields["lecture"].strip():
            out += f"LECTURE: {fields['lecture']}\n"
        if fields["solution"].strip():
            out += f"SOLUTION: {fields['solution']}\n"
        out += "###\n"
        out += f"ANSWER: {fields['answer']}."
    else:
        out = _OUTPUT_TEMPLATES[output_format].format(**fields)
    return inp, out


def _squeeze(s: str) -> str:
    return s.replace("  ", " ").strip()


def _strip_because(s: str) -> str:
    return s.replace("BECAUSE:", "").strip() if s.endswith("BECAUSE:") else s


def create_one_example(prompt_format: str, fields: Dict[str, str],
                       test_example: bool = True) -> str:
    """Plain concatenated form (reference lines 107-159): input+output
    cleaned as ONE string."""
    inp, out = _render(prompt_format, fields, test_example, allow_lepa=False)
    return _strip_because(_squeeze(inp + out))


def create_one_example_chatbot(prompt_format: str, fields: Dict[str, str],
                               test_example: bool = True) -> Tuple[str, str]:
    """(input, output) pair, cleaned separately (reference lines 41-105)."""
    inp, out = _render(prompt_format, fields, test_example, allow_lepa=True)
    return _strip_because(_squeeze(inp)), _strip_because(_squeeze(out))


def create_one_example_gpt4(prompt_format: str, fields: Dict[str, str],
                            test_example: bool = True) -> Tuple[dict, dict]:
    """GPT-4 chat-message pair (reference lines 163-222).  Quirk kept for
    parity: only the OUTPUT gets the trailing-BECAUSE strip here."""
    inp, out = _render(prompt_format, fields, test_example, allow_lepa=False)
    inp, out = _squeeze(inp), _strip_because(_squeeze(out))
    return ({"role": "user", "content": f"Can you explain {inp}?"},
            {"role": "assistant", "content": out})


def build_prompt_chatbot(problems: Dict[str, dict],
                         shot_qids: Sequence[str], prompt_format: str,
                         use_caption: bool = False,
                         options: Sequence[str] = DEFAULT_OPTIONS,
                         is_test: bool = False) -> Dict[str, Tuple[str, str]]:
    """qid -> (input, output) training pairs (reference lines 225-245).
    Lecture/solution newlines are REAL newlines here (line 240-241)."""
    return {
        qid: create_one_example_chatbot(
            prompt_format,
            problem_fields(problems[qid], use_caption, options,
                           escape_newlines=False),
            test_example=is_test)
        for qid in shot_qids
    }


def build_prompt(problems: Dict[str, dict], shot_qids: Sequence[str],
                 test_qid: str, prompt_format: str,
                 use_caption: bool = False,
                 options: Sequence[str] = DEFAULT_OPTIONS) -> str:
    """n-shot plain prompt: shot examples + 'Answer:'-terminated test
    example, '\\n\\n'-joined (reference lines 248-291)."""
    parts = [
        create_one_example(
            prompt_format,
            problem_fields(problems[qid], use_caption, options),
            test_example=False)
        for qid in shot_qids
    ]
    parts.append(create_one_example(
        prompt_format, problem_fields(problems[test_qid], use_caption,
                                      options), test_example=True))
    return "\n\n".join(parts)


def build_prompt_gpt4(problems: Dict[str, dict], shot_qids: Sequence[str],
                      test_qid: str, prompt_format: str,
                      use_caption: bool = False,
                      options: Sequence[str] = DEFAULT_OPTIONS) -> List[dict]:
    """n-shot GPT-4 message array with a system prompt (reference
    lines 294-333)."""
    messages = [{"role": "system", "content": "You are a helpful assistant."}]
    for qid in list(shot_qids) + [test_qid]:
        user, assistant = create_one_example_gpt4(
            prompt_format,
            problem_fields(problems[qid], use_caption, options),
            test_example=(qid == test_qid))
        messages += [user, assistant]
    return messages
