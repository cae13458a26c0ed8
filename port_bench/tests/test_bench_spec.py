"""BENCHMARK.json against the benchmark's contract, and every piece it
names present under ``port_bench/``."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + metrics(),
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("metric", metrics(), ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        # every cell the metric reads in reports the metric it moves
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in metric["name"]:
            assert metric["unit"] == "%"


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("port_bench/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] == []
    assert data["name"] == conf["name"] and data["source"] == conf["source"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "traffic" / f"{mix['kind']}.py").exists()
    local = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
    assert set(local) == {"route", "limits"}
    reported = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in BENCH["per_layer"])


def test_four_chip_cells():
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_config_used():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
