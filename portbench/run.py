"""Run one cell of the port's benchmark once, on the card, and print one
JSON line as the last line of standard output::

    python3 portbench/run.py --workload hpcg-32x32x24.ell --seed 7 \\
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (one analysis under ``torch.profiler``, the program's
spans and counters on).  Every run compares what its window produced with
the plain reference and prints each number compared beside its limit, as
the last lines of standard error and as the last key (``checks``) of the
result line.

It runs from the root of a checkout, builds the port's kernels into the
port's own ``src/repro_torch/kernels/_build/`` there, keeps every other
cache under ``.portbench/`` there, and fails, printing no result, when no
CUDA card is present: it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()           # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# module names the process may not hold once the window has closed: JAX and
# the JAX package (top-level names compared whole: the port's own name,
# ``repro_torch``, only starts with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver gets: the run's arguments and cell, the program, and
    where its analyses run."""

    args: argparse.Namespace
    cell: dict
    cfg: dict
    mix: dict
    torch: object
    program: object
    device: str
    t_start: float

    @staticmethod
    def log(msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cache_env() -> None:
    """Every cache a library could write, at fixed paths in the checkout."""
    cache = ROOT / ".portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_and_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc!r})"


def main(argv=None, *, device: str = "cuda", cell_data=None) -> dict:
    """One run.  ``device`` and ``cell_data`` (``{"cell", "cfg", "mix"}``)
    exist for the harness's own CPU tests, which drive a run with no card
    and a small cell; the command line always runs on the card."""
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import layout

    bench = layout.benchmark()
    if cell_data is None:
        cell = layout.workload(bench, args.workload)
        cfg = layout.config(bench, cell["config"])
        mix = layout.traffic(cell["traffic"])
    else:
        cell, cfg, mix = (cell_data["cell"], cell_data["cfg"],
                          cell_data["mix"])
    cache_env()
    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            fail("no CUDA card is visible (torch.cuda.is_available() is "
                 "false); this benchmark runs only on the card")
        if torch.cuda.device_count() < cell["chips"]:
            fail(f"{args.workload} needs {cell['chips']} card(s), "
                 f"{torch.cuda.device_count()} visible")
        torch.cuda.init()
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the program is missing: no {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    import repro_torch

    ctx = Context(args=args, cell=cell, cfg=cfg, mix=mix, torch=torch,
                  program=repro_torch, device=device, t_start=T_START)
    card = card_and_power_limit() if device != "cpu" else "cpu"
    ctx.log(f"card: {card}")
    driver = layout.module("drivers", mix["driver"])
    res = driver.run(ctx)

    bad = forbidden_modules()
    if bad:
        fail(f"the process holds {bad} after the window: nothing the run "
             f"loads may import JAX or the JAX package", 3)

    from portbench import compare

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in layout.metrics(bench, cell["name"], kind):
        if args.trace:
            value = layout.module("metrics", m["name"]).read(res["obs"])
        else:
            value = res["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (res["failed"] == 0 and res["compared"] == res["attempted"]
               and res["compared"] > 0 and compare.passed(res["checks"]))
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"],
           "name_and_power_limit": card}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace and "profile" in res["obs"]:
        dev["busy_s"] = res["obs"]["profile"]["busy_s"]
        dev["window_s"] = res["obs"]["profile"]["wall_s"]
        out["breakdown"] = res["obs"]["breakdown"]
    checks = {k: {"value": v, "limit": compare.LIMITS[k]}
              for k, v in res["checks"].items()}
    checks["analyses_compared"] = {"value": res["compared"],
                                   "limit": res["attempted"]}
    out["checks"] = checks
    for k, c in checks.items():
        rel = ">=" if k == "analyses_compared" else "<="
        print(f"check {k} {c['value']} (limit {rel} {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
