"""`BENCHMARK.json` against the benchmark's contract, and the files each
of its entries names."""
from __future__ import annotations

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$"
                   r"|_rank$|head|expansion|experts_per_token)")


def cells_reporting(metric: dict) -> set:
    return set(metric.get("workloads",
                          [w["name"] for w in BENCH["workloads"]]))


def test_top_level_keys():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert os.path.exists(os.path.join(ROOT, word))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert NAME.match(entry["name"])
    assert entry["source"].startswith("https://")
    assert entry["file"].startswith("cookbench/")
    path = os.path.join(ROOT, entry["file"])
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert cfg["assumed"], "every configuration lists what it assumed"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                       f"{cell['traffic']}.json"))
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in cells_reporting(m)]
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert any(cell["name"] in cells_reporting(m)
               for m in BENCH["per_layer"])


def test_unique_names_and_pairs():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES_E2E
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    # the end-to-end metric it moves is reported by every cell that
    # reports it
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    assert cells_reporting(metric) <= cells_reporting(moved)
    assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                       f"{metric['name']}.py"))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    """Metrics of one layer give it letter for letter; PERF.md lists each
    layer."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for metric in BENCH["per_layer"]:
        assert metric["layer"] in perf, metric["layer"]


def test_check_budget():
    """A full check of 24 cells at this run length fits its limit."""
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200
