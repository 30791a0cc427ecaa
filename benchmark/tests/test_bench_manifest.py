"""BENCHMARK.json against the contract, and the harness's files found by
name: every cell's configuration, traffic mix and driver, every metric's
reader, and a cell added from files alone."""

import json
import re
import shutil

import pytest

from benchmark.harness import common

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP_KEYS
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_are_found_by_name(cell):
    wl = common.workload(cell["name"])
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"]
    cfg = common.config(cell["config"])
    assert cfg["name"] == cell["config"]
    mix = common.traffic(cell["traffic"])
    assert mix["kind"] in ("conversations", "questions")
    assert (common.BENCH_DIR / "drivers" / f"{wl['driver']}.py").exists()
    for name in wl["limits"]:
        assert isinstance(wl["limits"][name], float)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_hold_what_is_run(cfg):
    body = json.loads((common.ROOT / cfg["file"]).read_text())
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    assert cfg["file"].startswith("benchmark/")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]
    assert (common.BENCH_DIR / "metrics" / f"{metric['name']}.py").exists()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for cell in SPEC["workloads"]:
        e2e = [m["name"] for m in common.cell_metrics(cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert common.cell_metrics(cell["name"], True)


def test_a_cell_added_from_files_alone_loads(tmp_path, monkeypatch):
    """A later PR adds a configuration, a traffic mix, a cell and a
    metric as files and entries; the harness finds them by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(common.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "llavamod-2b.json").read_text())
    cfg["name"] = "new-model"
    (bench / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "short_vqa.json").read_text())
    mix["max_new_tokens"] = [64]
    (bench / "traffic" / "long_vqa.json").write_text(json.dumps(mix))
    cell = json.loads((bench / "workloads" / "serve.2b.short.json").read_text())
    cell.update(config="new-model", traffic="long_vqa")
    (bench / "workloads" / "serve.new.long.json").write_text(json.dumps(cell))
    (bench / "metrics" / "new_metric.serve.py").write_text(
        "def read(ctx):\n    return ctx.get('rows')\n")
    spec["workloads"].append({"name": "serve.new.long", "config": "new-model",
                              "traffic": "long_vqa", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric.serve", "unit": "rows",
                              "better": "higher", "source": "program_counter",
                              "layer": "server",
                              "moves": "serve_requests_per_s",
                              "workloads": ["serve.new.long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(common, "BENCH_DIR", bench)
    monkeypatch.setattr(common, "ROOT", tmp_path)
    wl = common.workload("serve.new.long")
    assert common.config(wl["config"])["name"] == "new-model"
    assert common.traffic(wl["traffic"])["max_new_tokens"] == [64]
    names = [m["name"] for m in common.cell_metrics("serve.new.long", True)]
    assert names == ["new_metric.serve"]
    from benchmark import run

    assert run.read_metric("new_metric.serve", {"rows": 3}) == 3
