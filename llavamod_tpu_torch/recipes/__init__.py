"""The port's recipes: copies of the JAX package's scripts/recipes that call
the port's entry points, with the same names, flags and environment
variables.

    JSON_FILE=... IMAGE_FOLDER=... bash llavamod_tpu_torch/recipes/train/pretrain.sh
    MODEL_PATH=... bash llavamod_tpu_torch/recipes/eval/pope.sh

`recipe_commands` reads the `python -m` commands out of a recipe, with its
variables resolved, so that a program can run a recipe as written (the
bring-up smoke runs stage 2a this way) and a test can parse its flags.
"""

from __future__ import annotations

import os
import re
import shlex
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

RECIPES_DIR = Path(__file__).resolve().parent
# the training entry points and the stage each runs (train/run.py::main)
STAGES = {"llavamod_tpu_torch.train.train": "pretrain",
          "llavamod_tpu_torch.train.align_train": "align",
          "llavamod_tpu_torch.train.dpo_train": "dpo"}

_BASENAME = re.compile(r'\$\(basename "([^"]*)"\)')
_DEFAULT = re.compile(r"\$\{(\w+):-'?([^}']*)'?\}")
_REQUIRED = re.compile(r"\$\{(\w+):\?\}")
_PLAIN = re.compile(r"\$\{(\w+)\}")


def _logical_lines(text: str) -> List[str]:
    """The script's lines with `\\` continuations joined, comments and
    blank lines dropped."""
    out, cur = [], ""
    for line in text.splitlines():
        if line.rstrip().endswith("\\"):
            cur += line.rstrip()[:-1] + " "
            continue
        line = cur + line
        cur = ""
        line = re.sub(r"\s+#[^'\"]*$", "", line).strip()
        if line and not line.startswith("#"):
            out.append(line)
    return out


def _expand(text: str, values: Dict[str, str], env: Mapping[str, str]) -> str:
    def default(m):
        return env.get(m.group(1)) or m.group(2)

    def required(m):
        if m.group(1) not in env:
            raise ValueError(f"the recipe needs {m.group(1)} set")
        return env[m.group(1)]

    # inner references first: a default may name another variable
    text = _PLAIN.sub(lambda m: values.get(m.group(1), env.get(m.group(1),
                                                                 "")), text)
    text = _DEFAULT.sub(default, text)
    text = _REQUIRED.sub(required, text)
    return _BASENAME.sub(lambda m: os.path.basename(m.group(1)), text)


def recipe_commands(path, env: Optional[Mapping[str, str]] = None
                    ) -> List[Tuple[str, List[str]]]:
    """(module, argv) of each `python -m <module> ...` command of the recipe
    at `path`, in order; its variables take their values from `env` and
    else from the defaults the recipe writes (`${VAR:-default}`), as bash
    would run it.  A `${VAR:?}` without a value in `env` raises."""
    env = dict(env or {})
    values: Dict[str, str] = {}
    commands = []
    for line in _logical_lines(Path(path).read_text()):
        for stmt in (s.strip() for s in line.split(";")):
            m = re.match(r"^([A-Za-z_]\w*)=(.*)$", stmt)
            if m:
                values[m.group(1)] = _expand(m.group(2), values, env)
                continue
            words = shlex.split(_expand(stmt, values, env))
            if words[:2] == ["python", "-m"]:
                commands.append((words[2], words[3:]))
    return commands
