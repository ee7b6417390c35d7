"""BENCHMARK.json against the contract it is written to, and every name in
it resolved to its files."""

import importlib
import json
import re

import pytest

from perfbench import harness, traffic

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    cfg, asset, _ = harness.load_config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    mode = harness.load_module("traffic", traffic.load_mix(cell["traffic"])["mode"])
    assert callable(mode.run)
    cfg = harness.load_json("configs", cell["config"])
    assert callable(importlib.import_module(f"perfbench.reference.{cfg['reference']}").step)
    harness.load_module("work", f"{cfg['family']}_{mode.WORK}").model_flops
    limits = harness.load_json("workloads", cell["name"])["limits"]
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if harness.applies(m, cell["name"])]
    assert layer and all(harness._reports(SPEC, m, cell["name"]) for m in layer)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_names(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda e: e["name"])
def test_reader_resolves(metric):
    assert callable(harness.load_module("metrics", metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_pairs_unique_and_size():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(SPEC)) < 64 * 1024
