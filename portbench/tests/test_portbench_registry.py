"""Everything BENCHMARK.json names is found by name under portbench/, and
the files agree with their entries."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import spec
from portbench.traffic import load_mix
from portbench.tests.conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_its_entry(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = spec.cell(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert c[key] == entry[key], key
    assert load_mix(spec.mix_path(c["traffic"]))["clients"] >= 1
    cfg = spec.config(c["config"])
    kind = spec.kind(cfg["kind"])
    assert hasattr(kind, "check") and hasattr(kind, "ProgramApi")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_matches_its_entry(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    cfg = spec.config(config)
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert 1 <= len(entry["source"]) <= 200 and "\n" not in entry["source"]
    assert "guarantees" in cfg and "assumed" in cfg
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_and_agrees(metric):
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == metric)
    reader = spec.metric(metric)
    assert callable(reader.read)
    assert reader.UNIT == entry["unit"]
    if entry in BENCH["per_layer"]:
        assert reader.LAYER == entry["layer"]
        assert reader.MOVES == entry["moves"]
        assert entry["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    for cell in entry.get("workloads", []):
        assert cell in CELLS


def test_names_and_limits():
    names = CELLS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    assert BENCH["paths"] == ["portbench"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in spec.cell_metrics(BENCH, cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(BENCH, cell, "per_layer")


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.cell("no-such-cell")
    with pytest.raises(ValueError):
        spec.metric("../run")
    with pytest.raises(FileNotFoundError):
        spec.metric("ops_per_launch.some-cell")  # that reader has no per-cell form


@pytest.mark.parametrize("suffix", ["bulk-contains", "a-mix-added-later"])
def test_a_suffixed_metric_is_its_base_reader_per_cell(suffix):
    m = spec.metric(f"call_p99_ms.{suffix}")
    base = spec.metric("call_p99_ms")
    assert (m.UNIT, m.LAYER, m.MOVES) == ("ms", "client", "ops_per_s")
    code, want = m.read.__code__, base.read.__code__
    assert (code.co_filename, code.co_firstlineno) == (want.co_filename, want.co_firstlineno)


def test_the_read_back_uses_the_programs_public_calls():
    """Rows come through DUMP and counters through the registry's
    families; only the replica rows, which no public call reads, reach
    into the program's engine."""
    import re

    hits = []
    for dirpath, _, files in os.walk(spec.ROOT):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                hits += [(f, h) for h in re.findall(
                    r"\b(?:client|eng|reg|registry|e|handle|h)\._\w+", src)]
    assert hits == [("__init__.py", "client._engine")], hits


@pytest.mark.parametrize("folder", ["workloads", "configs", "traffic", "kinds", "loops",
                                    "metrics"])
def test_every_file_is_found_by_its_name(folder):
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(spec.ROOT, folder))
                   if f.endswith((".json", ".py")) and not f.startswith("__"))
    assert names
    for name in names:
        if folder == "workloads":
            assert spec.config(spec.cell(name)["config"])
        elif folder == "configs":
            assert spec.kind(spec.config(name)["kind"]).Space
        elif folder == "traffic":
            load_mix(spec.mix_path(name))
        elif folder == "kinds":
            assert callable(spec.kind(name).check)
        elif folder == "loops":
            assert callable(spec.loop(name).client) and spec.loop(name).KEYS is not None
        else:
            m = spec.metric(name)
            assert callable(m.read) and m.UNIT and m.LAYER and m.MOVES
