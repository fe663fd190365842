"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and per-layer metric is a file of its own under bench_port/,
found by its name."""
import json
import re

import pytest

from bench_port import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = manifest.benchmark()


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_are_unique_and_valid():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = manifest.config(cfg["name"])
    assert cfg["file"] == f"bench_port/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"]
    assert cfg["reduced"] == []
    assert data["dtype"] == "float32"
    assert set(data["limits"]) >= {"reset_gap", "physics_gap", "env_gap",
                                   "flags_differ"}
    if data["policy"]:
        assert (manifest.HERE / "configs" / data["policy"]["file"]).is_file()
        assert "action_gap" in data["limits"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    wl = manifest.workload(cell["name"])
    assert wl == {"config": cell["config"], "traffic": cell["traffic"]}
    manifest.config(cell["config"])
    t = manifest.traffic(cell["traffic"])
    assert t["num_envs"] > 0 and t["actions"] in ("uniform", "policy")
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell["name"])


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    assert callable(manifest.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_lookup_refuses_other_names():
    with pytest.raises(ValueError):
        manifest.workload("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        manifest.traffic("no_such_mix")


def test_per_layer_selection():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b",
                                            "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in manifest.per_layer(bench, "x")] == ["p", "q"]
    assert [m["name"] for m in manifest.per_layer(bench, "y")] == ["p", "r"]
    json.dumps(bench)
