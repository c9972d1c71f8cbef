"""BENCHMARK.json against the files it names, the rules its shape keeps
(names, units, bounds, keys), and the import hygiene of every module of
the harness."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench import layout

BENCH = layout.benchmark()
HERE = layout.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    cfg = layout.config(BENCH, cell["config"])
    layout.module("generators", cfg["generator"])
    mix = layout.traffic(cell["traffic"])
    assert hasattr(layout.module("drivers", mix["driver"]), "run")
    # a cell reports setup_s, another end-to-end metric, a per-layer one
    e2e = [m["name"] for m in layout.metrics(BENCH, cell["name"],
                                             "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layout.metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_every_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = layout.ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["name"] == entry["name"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert len(entry["source"]) <= 200


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_resolves(metric):
    assert hasattr(layout.module("metrics", metric["name"]), "read")
    assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    for w in metric["workloads"]:
        assert metric["moves"] in [m["name"] for m in layout.metrics(
            BENCH, w, "end_to_end")]


def test_names_units_and_bounds():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((kind in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in BENCH["end_to_end"]] == ["analyze_s",
                                                        "setup_s"]
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        # top-level names compared whole: repro_torch only starts with repro
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_check_compares_whole_names():
    from portbench import run

    assert "repro_torch".split(".")[0] not in run.FORBIDDEN
    assert "repro.core".split(".")[0] in run.FORBIDDEN
