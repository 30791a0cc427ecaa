"""The JAX package's last public helpers in the port, against the JAX
functions:

  * `models/llm/upcycle.py::activated_params`: the same integer on every
    decoder preset of both packages, and on the Qwen1.5-1.8B preset
    upcycled as the bring-up smoke's student (4 experts, top-2, every 2nd
    layer);
  * `utils/logging.py::build_logger` and `StreamToLogger` (exported from
    `utils/__init__.py` as in the JAX package): the same records for the
    same writes (line splitting, the partial line kept until a newline or
    `flush`), and the same lines in the daily-rotating file."""

import dataclasses
import logging

import pytest

import llavamod_tpu.utils as jutils
from llavamod_tpu.models.llm import upcycle as jupcycle
from llavamod_tpu.models.llm.config import DecoderConfig as JDecoderConfig
from llavamod_tpu.models.llm.config import llm_configs as jconfigs
from llavamod_tpu.utils import logging as jlog
import llavamod_tpu_torch.utils as tutils
from llavamod_tpu_torch.models.llm import upcycle as tupcycle
from llavamod_tpu_torch.models.llm.config import DecoderConfig
from llavamod_tpu_torch.models.llm.config import llm_configs as tconfigs
from llavamod_tpu_torch.models.llm.config import moe_layer_indices
from llavamod_tpu_torch.utils import logging as tlog

PRESETS = [("jax", n) for n in jconfigs.names()] + [
    ("port", n) for n in tconfigs.names()]


@pytest.mark.parametrize("pkg,name", PRESETS)
def test_activated_params_equals_jax_on_every_preset(pkg, name):
    if pkg == "jax":
        jcfg = jconfigs.get(name)
        tcfg = DecoderConfig(**dataclasses.asdict(jcfg))
    else:
        tcfg = tconfigs.get(name)
        jcfg = JDecoderConfig(**dataclasses.asdict(tcfg))
    got = tupcycle.activated_params(tcfg)
    assert isinstance(got, int) and got > 0
    assert got == jupcycle.activated_params(jcfg)


def test_activated_params_of_the_smokes_student():
    """Qwen1.5-1.8B upcycled to 4 experts, top-2, on the even layers: the
    paper's "2B activated"."""
    dense = tconfigs.get("qwen1.5-1.8b")
    moe = dense.replace(moe_num_experts=4, moe_top_k=2,
                        moe_layers=moe_layer_indices("sparse",
                                                     dense.num_layers))
    got = tupcycle.activated_params(moe)
    assert got == jupcycle.activated_params(
        JDecoderConfig(**dataclasses.asdict(moe)))
    mlp = 3 * dense.hidden_size * dense.intermediate_size
    assert got - tupcycle.activated_params(dense) == len(moe.moe_layers) * (
        mlp + dense.hidden_size * 4)
    assert 2.0e9 < got < 2.5e9


def test_utils_exports_the_same_names():
    for name in ("build_logger", "rank0_print", "Registry", "order_pick_k"):
        assert hasattr(tutils, name) and hasattr(jutils, name), name
    assert tutils.build_logger is tlog.build_logger


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.seen = []

    def emit(self, record):
        self.seen.append((record.levelno, record.getMessage()))


WRITES = ["hello", " world\npart", "ial\n\nlast line, no newline", "",
          "  indented\ttab  \n", "x"]


def test_stream_to_logger_and_build_logger_match_jax(tmp_path, monkeypatch):
    out = {}
    try:
        for pkg, mod in (("jax", jlog), ("port", tlog)):
            monkeypatch.setattr(mod, "_handler", None)
            logger = mod.build_logger(f"llavamod_test_{pkg}", "run.log",
                                      str(tmp_path / pkg))
            records = _Records()
            logger.addHandler(records)
            stream = mod.StreamToLogger(logger, logging.WARNING)
            pending = []
            for w in WRITES:
                stream.write(w)
                pending.append(stream.linebuf)
            stream.flush()
            stream.flush()                  # a second flush logs nothing
            assert stream.closed is stream.terminal.closed   # delegated
            mod._handler.flush()
            lines = (tmp_path / pkg / "run.log").read_text().splitlines()
            logger.removeHandler(records)
            out[pkg] = dict(records=records.seen, pending=pending,
                            lines=[ln.split(" | ", 3) for ln in lines])
    finally:
        for mod in (jlog, tlog):
            h = mod._handler
            if h is not None:
                for item in logging.root.manager.loggerDict.values():
                    if isinstance(item, logging.Logger):
                        item.removeHandler(h)
                h.close()
    got, want = out["port"], out["jax"]
    assert got["records"] == want["records"]
    assert got["records"][0] == (logging.WARNING, "hello world")
    assert got["records"][-1] == (logging.WARNING, "x")
    assert got["pending"] == want["pending"]
    assert len(got["lines"]) == len(want["lines"]) == len(want["records"])
    for g, w in zip(got["lines"], want["lines"]):
        assert (g[1], g[3]) == (w[1], w[3])
        assert (g[2], w[2]) == ("llavamod_test_port", "llavamod_test_jax")
