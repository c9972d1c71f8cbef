"""Whole runs of the harness on the CPU: the refusal without a card, and a
small cell driven end to end (its look for a card skipped), sound and with
the timed path broken underneath, where ``correct`` must come out false."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import control, layout, run

CELL = {"name": "hpcg-tiny.ell", "config": "hpcg-tiny", "traffic": "ell",
        "chips": 1, "why": "test"}
CFG = {"generator": "hpcg27", "params": {"nx": 8, "ny": 8, "nz": 8},
       "options": {"concurrency": 128, "supernode_relax": 0,
                   "supernode_max_size": 64}}


def drive(seed=3, trace=0):
    return run.main(["--workload", CELL["name"], "--seed", str(seed),
                     "--seconds", "0.5", "--trace", str(trace)],
                    device="cpu", cell_data={"cell": CELL, "cfg": CFG,
                                             "mix": layout.traffic("ell")})


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH_CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=layout.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


BENCH_CELL = layout.benchmark()["workloads"][0]["name"]


def test_refuses_in_a_directory_of_only_the_benchmark(tmp_path):
    shutil.copy(layout.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(layout.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", BENCH_CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_sound_run_is_correct(capsys):
    out = drive(seed=2**31 + 11)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"analyze_s", "setup_s"}
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == out
    assert list(out)[-1] == "checks"
    assert printed.err.strip().splitlines()[-1].startswith(
        "check analyses_compared")


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "relaxed"])
def test_a_broken_path_is_not_correct(fault):
    import repro_torch

    with control.FAULTS[fault](repro_torch):
        out = drive(seed=5)
    assert not out["correct"]
    assert sum(v["value"] for k, v in out["checks"].items()
               if k != "analyses_compared") > 0


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_control_readings(seed):
    import repro_torch

    mix = layout.traffic("ell")
    sound = control.readings(repro_torch, CFG, mix, seed, "sound", "cpu")
    assert sound == {"pattern_mismatch": 0, "supernode_mismatch": 0,
                     "level_mismatch": 0}
    relaxed = control.readings(repro_torch, CFG, mix, seed, "relaxed",
                               "cpu")
    assert relaxed["supernode_mismatch"] > 0


SPAN_READER = '''
def read(obs):
    prof = obs.get("profile")
    if not prof:
        return None
    by_spans = sum(e - s for name, s, e, _ in prof["spans"]
                   if name == "pattern_collect") / 1e9
    by_stats = obs["analyses"][0]["stats"].find("pattern_collect").total_s
    return [by_spans, by_stats]
'''


def test_a_new_metric_is_one_reader_file(tmp_path, monkeypatch):
    """A per-layer metric read from the program's spans is added as one
    file and one entry: the driver hands readers the spans and span trees
    as the program recorded them."""
    copy = tmp_path / "portbench"
    shutil.copytree(layout.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "fixpoint.pattern_collect_s.py").write_text(
        SPAN_READER)
    bench = layout.benchmark()
    bench["per_layer"].append({
        "name": "fixpoint.pattern_collect_s", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "fixpoint", "moves": "analyze_s",
        "workloads": [CELL["name"]]})
    monkeypatch.setattr(layout, "HERE", copy)
    monkeypatch.setattr(layout, "benchmark", lambda: bench)
    out = drive(seed=12, trace=1)
    by_spans, by_stats = out["metrics"]["fixpoint.pattern_collect_s"][
        "value"]
    assert out["correct"] and by_spans > 0
    assert by_spans == pytest.approx(by_stats, rel=1e-6, abs=1e-6)
