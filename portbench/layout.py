"""Finds every part of a cell by the name ``BENCHMARK.json`` gives it, so
that a configuration, a traffic mix, a generator, a driver or a per-layer
metric is added as one file and one entry, with no edit elsewhere:

* configuration ``<c>``: the JSON file its entry names
  (``portbench/configs/<c>.json``), with the pattern generator, its
  parameters and the ``LUOptions`` fields of the deployment;
* traffic mix ``<t>``: ``portbench/traffic/<t>.json``, naming the driver of
  the window and the per-request ``LUOptions``;
* generator ``<g>``: ``portbench/generators/<g>.py`` (``generate``);
* driver ``<d>``: ``portbench/drivers/<d>.py`` (``run``);
* per-layer metric ``<m>``: ``portbench/metrics/<m>.py`` (``read``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, workload_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])]
