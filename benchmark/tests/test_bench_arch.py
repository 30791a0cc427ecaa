"""The decoder's layout behind the configuration's `architecture`: the
accepted configurations read through the harness exactly as they did
before it moved there (parent_snapshot.json, benchmark/tests/snapshot.py),
an architecture that exists only as files under another directory is
drawn, counted and referenced through the harness with no edit to it, and
a name without its files fails at once, naming them."""

import json
import math
import textwrap
from pathlib import Path

import pytest
import torch

from benchmark.harness import common, flops
from benchmark.harness import weights as wmod
from benchmark.reference import model as rm
from benchmark.tests import snapshot, tiny

PARENT = json.loads((Path(__file__).with_name("parent_snapshot.json"))
                    .read_text())


@pytest.fixture(scope="module")
def now():
    threads = torch.get_num_threads()
    try:
        return json.loads(json.dumps(snapshot.snapshot()))
    finally:
        torch.set_num_threads(threads)


def _close(got, want, path="") -> None:
    """Equal, floats within rounding of the CPU's kernels."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-9), \
            (path, got, want)
    else:
        assert got == want, path


@pytest.mark.parametrize("part", ["layout", "counts", "tensors"])
def test_the_accepted_configurations_are_laid_out_counted_and_drawn_as_before(
        now, part):
    assert now[part] == PARENT[part]


@pytest.mark.parametrize("part", ["reference", "readings"])
def test_the_reference_reads_as_before(now, part):
    _close(now[part], PARENT[part], part)


HARNESS_ARCH = '''
    """A toy decoder: per layer x + relu(rmsnorm(x) @ up) @ down, no
    attention."""


    def groups(cfg):
        d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
        out = {"llm.embed": [("llm.embed.embedding", (v, d), "normal")]}
        for i in range(cfg["num_hidden_layers"]):
            pre = f"llm.layers.{i}"
            out[pre] = [(pre + ".norm.weight", (d,), "ones"),
                        (pre + ".up", (d, f), "dense"),
                        (pre + ".down", (f, d), "dense")]
        out["llm.final_norm"] = [("llm.final_norm.weight", (d,), "ones")]
        out["llm.lm_head"] = [("llm.lm_head.weight", (v, d), "normal")]
        return out


    def decoder_config(cfg):
        return {"name": cfg["name"], "vocab_size": cfg["vocab_size"]}


    def linear_macs_per_token(cfg):
        return 0, cfg["num_hidden_layers"] * 2 * cfg["hidden_size"] * cfg["intermediate_size"]


    def attention_core(cfg, n):
        return 0.0


    def decode_attention(cfg, ctx):
        return 0.0


    def attention_work(cfg, n, kind):
        return 0.0, 0.0
'''

REFERENCE_ARCH = '''
    import torch

    from benchmark.reference.model import rms_norm

    INT8_LEAVES = ("up", "down")


    def decoder(emb, W, cfg, lin, cap_tokens, train, remat=False,
                margins=None, segments=None):
        x = emb.float()
        for i in range(cfg["num_hidden_layers"]):
            pre = f"llm.layers.{i}"
            h = rms_norm(x, W[pre + ".norm.weight"], cfg["rms_norm_eps"])
            x = x + lin(torch.relu(lin(h, pre + ".up")), pre + ".down")
        return (rms_norm(x, W["llm.final_norm.weight"], cfg["rms_norm_eps"]),
                torch.zeros((), device=emb.device))
'''


def test_an_architecture_joins_by_files_alone(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for side, body in (("harness", HARNESS_ARCH), ("reference", REFERENCE_ARCH)):
        (bench / side / "arch").mkdir(parents=True)
        (bench / side / "arch" / "toy.py").write_text(textwrap.dedent(body))
    monkeypatch.setattr(common, "BENCH_DIR", bench)
    cfg = dict(tiny.TEACHER, name="toy", architecture="toy",
               intermediate_size=48, num_hidden_layers=3)
    # drawn: the shared tower and projector, then the toy's groups
    groups = list(wmod.groups(cfg))
    assert groups[0] == "vision.stem" and groups[-7:] == [
        "projector", "llm.embed", "llm.layers.0", "llm.layers.1",
        "llm.layers.2", "llm.final_norm", "llm.lm_head"]
    W = wmod.make_state(cfg, 5, "model", "cpu", torch.float32)
    assert W["llm.layers.2.up"].shape == (96, 48)
    # counted
    assert flops.linear_macs_per_token(cfg) == (0, 3 * 2 * 96 * 48)
    assert flops.serve_request(cfg, 10, 3)["bf16"] > flops.serve_request(
        cfg, 10, 1)["bf16"]
    # referenced: the shared embedding and head around the toy's decoder
    lin = rm.Linear(W, rm.Numerics())
    ids = torch.arange(7)
    h, aux = rm.decoder(rm.embed(ids, W, torch.zeros(0, 96), -1), W, cfg, lin,
                        cap_tokens=7, train=False)
    assert rm.head(h, W, lin).shape == (7, cfg["vocab_size"]) and aux == 0
    assert rm.arch(cfg).INT8_LEAVES == ("up", "down")


def test_an_architecture_without_its_files_fails_naming_them():
    cfg = dict(tiny.STUDENT, architecture="not_there")
    with pytest.raises(FileNotFoundError) as err:
        wmod.groups(cfg)
    msg = str(err.value)
    assert "benchmark/harness/arch/not_there.py" in msg
    assert "benchmark/reference/arch/not_there.py" in msg
    with pytest.raises(FileNotFoundError):
        flops.linear_macs_per_token(dict(cfg, architecture=None))
