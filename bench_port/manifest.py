"""Finds a cell's files by name: ``workloads/<name>.json`` names its
configuration (``configs/<name>.json``) and traffic (``traffic/<name>.json``);
``BENCHMARK.json`` at the checkout's root lists the metrics, and each
per-layer metric is read by ``metrics/<name>.py``.  A later cell, traffic
mix, configuration or metric is a new file here, found by its name."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name}")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def policy_path(cfg: dict):
    return HERE / "configs" / cfg["policy"]["file"] if cfg.get("policy") \
        else None


def end_to_end(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
