"""The per-layer metrics read from the program's spans, in a traced run of a
small cell on the CPU: each reads a finite number of seconds, and the
fixpoint's wait on the device lies inside the fixpoint."""
import math
import types

import pytest

from portbench import layout, run

CELL = {"name": "hpcg-tiny.ell", "config": "hpcg-tiny", "traffic": "ell",
        "chips": 1, "why": "test"}
CFG = {"generator": "hpcg27", "params": {"nx": 8, "ny": 8, "nz": 8},
       "options": {"concurrency": 128, "supernode_relax": 0,
                   "supernode_max_size": 64}}
READERS = ("api.prepare_s", "api.self_s", "fixpoint.collect_s",
           "fixpoint.wait_s")


@pytest.fixture(scope="module")
def traced_run():
    """One ``--trace 1`` run with the span readers listed for the small
    cell, and the recordings (`obs`) the readers were given."""
    bench = layout.benchmark()
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"] = m["workloads"] + [CELL["name"]]
    handed = {}
    module = layout.module

    def spying_module(kind, name):
        mod = module(kind, name)
        if kind != "drivers":
            return mod

        def run_and_keep(ctx):
            handed.update(mod.run(ctx))
            return handed
        return types.SimpleNamespace(run=run_and_keep)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layout, "benchmark", lambda: bench)
        mp.setattr(layout, "module", spying_module)
        out = run.main(["--workload", CELL["name"], "--seed", "2147483659",
                        "--seconds", "0.5", "--trace", "1"], device="cpu",
                       cell_data={"cell": CELL, "cfg": CFG,
                                  "mix": layout.traffic("ell")})
    return out, handed["obs"]


@pytest.mark.parametrize("name", READERS)
def test_span_reader_reads_finite_seconds(traced_run, name):
    out, obs = traced_run
    assert out["correct"]
    value = out["metrics"][name]["value"]
    assert math.isfinite(value) and value >= 0
    assert out["metrics"][name]["unit"] == "s"
    if name == "fixpoint.wait_s":
        fixpoint = [a["stats"].find("fixpoint").total_s
                    for a in obs["analyses"]]
        assert value <= sum(fixpoint) / len(fixpoint)
