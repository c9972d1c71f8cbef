#!/usr/bin/env python3
"""Time edited copies of the port's CUDA kernels beside the committed ones,
in one process on one card.

    python3 tools/kernel_variants.py            # every experiment
    python3 tools/kernel_variants.py k5         # K5's only (or k1)

Each variant is the committed source in ``src/repro_torch/kernels/csrc/``
with the text replacements of its entry in ``EXPERIMENTS`` applied.  A
variant is a measurement, not a fix: some compute wrong results on
purpose (to find what a part of a kernel costs), and the script reports
whether each one still matches the plain version.  The variants are
compiled with the port's ``nvcc`` flags into ``build/variants/``
(gitignored), swapped in for the committed library, and timed on the
device alone (calls queued behind a spin kernel, as ``chip_smoke.py``'s
``device_ms``): K1 on the bbd-20k adjacency (the kernel path's shape) and
on a random 1 % 4096^2 one, K5 at the standing prefill shape
(8, 16, 512, 512, 64) and at smollm-135m's grouped prefill.  Prints one
JSON line per variant, then the card's name and power limit.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# (kernel, name) -> [(old text, new text), ...]
EXPERIMENTS = {
    ("k1", "committed"): [],
    # the stream alone: no tile is relaxed (wrong results)
    ("k1", "no_relax"): [("if (!__syncthreads_or(nz)) continue;",
                          "if (!__syncthreads_or(nz) || V > 0) continue;")],
    ("k1", "waves_4"): [("constexpr int WAVES = 16;",
                         "constexpr int WAVES = 4;")],
    ("k1", "waves_32"): [("constexpr int WAVES = 16;",
                          "constexpr int WAVES = 32;")],
    ("k1", "strips_in_order"): [
        ("const int strip = strips - 1 - blockIdx.x % strips;",
         "const int strip = blockIdx.x % strips;")],
    # plain stores in place of atomicMin (wrong results where two blocks
    # share a strip): what the merge costs
    ("k1", "stores_not_atomics"): [
        ("atomicMin(row + v0, acc0[i])", "row[v0] = acc0[i]"),
        ("atomicMin(row + v0 + 32, acc1[i])", "row[v0 + 32] = acc1[i]")],
    ("k5", "committed"): [],
    # one TF32 product in place of three (wrong results): what the two
    # correction products cost
    ("k5", "one_product"): [("""  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);""", "  mma_tf32(c, a_hi, b_hi);")],
    # no split (hi = x, lo = 0; wrong results): what the splits cost
    ("k5", "no_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  hi = __float_as_uint(x);
  lo = 0u;""")],
    # K/V tiles of 64 or 16 keys in place of 32: registers and shared
    # memory per block against barriers per key
    ("k5", "keys_64_per_tile"): [(
        "constexpr int BKV = 32;          // keys per tile",
        "constexpr int BKV = 64;          // keys per tile")],
    ("k5", "keys_16_per_tile"): [(
        "constexpr int BKV = 32;          // keys per tile",
        "constexpr int BKV = 16;          // keys per tile")],
    # 128 query rows (8 warps) per block sharing each K/V tile
    ("k5", "rows_128_per_block"): [
        ("constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows",
         "constexpr int PF_THREADS = 256;  // 4 warps x 16 query rows"),
        ("constexpr int BQ = 64;           // query rows per block",
         "constexpr int BQ = 128;          // query rows per block")],
    # the split with the conversion instruction, rounding both parts
    ("k5", "cvt_split"): [(
        """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;""",
        """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));""")],
}
SOURCE = {"k1": "minmax_relax", "k5": "flash_attention"}


def build(todo):
    """Compile every variant in parallel; {key: library path}."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in todo:
        kern, name = key
        text = (CSRC / f"{SOURCE[kern]}.cu").read_text()
        for old, new in EXPERIMENTS[key]:
            if old not in text:
                raise SystemExit(f"{key}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = OUT / f"{kern}_{name}.cu"
        cu.write_text(text)
        procs[key] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key} did not build:\n{log}")
        libs[key] = so
    return libs


def swap_in(kern, so):
    from repro_torch.kernels import _build

    symbol, argtypes = _build.SIGNATURES[SOURCE[kern]]
    fn = getattr(ctypes.CDLL(str(so)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _build._FUNCS[SOURCE[kern]] = fn


def device_ms(torch, fn, n=20, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def k1_cases(torch, np, rng):
    from repro_torch import sparse
    from repro_torch.core.gsofa import prepare_graph
    from repro_torch.kernels import plain

    a = sparse.bordered_block_diagonal(20_000, block=16, border=64, seed=3)
    cases = {"bbd": prepare_graph(a, dense_block=128,
                                  device="cuda").adj_dense,
             "random_4096": torch.as_tensor(
                 (rng.random((4096, 4096)) < 0.01).astype(np.uint8),
                 device="cuda")}
    out = {}
    for tag, adj in cases.items():
        u = adj.shape[0]
        prop = torch.as_tensor(rng.integers(0, u, size=(512, u)).astype(
            np.int32), device="cuda")
        out[tag] = ((prop, adj), plain.minmax_relax_plain(prop, adj))
    return out


def k5_cases(torch, np, rng):
    from repro_torch.kernels import plain

    out = {}
    for tag, (b, h, live, hkv, s, d) in {
            "standing_prefill": (8, 16, 16, 16, 512, 64),
            "smollm_prefill": (8, 16, 9, 3, 512, 64)}.items():
        q, k, v = (torch.as_tensor(rng.standard_normal(sh).astype(
            np.float32), device="cuda")
            for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        kw = {"causal": True, "live_heads": live}
        out[tag] = ((q, k, v, kw), plain.flash_attention_plain(q, k, v,
                                                                **kw))
    return out


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    kernels = argv or ["k1", "k5"]
    todo = [key for key in EXPERIMENTS if key[0] in kernels]
    libs = build(todo)
    rng = np.random.default_rng(0)
    cases = {"k1": k1_cases(torch, np, rng) if "k1" in kernels else {},
             "k5": k5_cases(torch, np, rng) if "k5" in kernels else {}}
    for key in todo:
        kern, name = key
        swap_in(kern, libs[key])
        line = {"kernel": kern, "variant": name}
        for tag, (args, want) in cases[kern].items():
            if kern == "k1":
                fn = lambda: ops.minmax_relax(*args)
                got = fn()
                right = bool(torch.equal(got, want))
                err = None
            else:
                q, k, v, kw = args
                fn = lambda: ops.flash_attention(q, k, v, **kw)
                got = fn()
                err = float((got - want).abs().max())
                right = err <= 2e-5
            line[tag] = {"ms": device_ms(torch, fn, n=10 if kern == "k1"
                                         else 20),
                         "matches_plain": right, "max_abs_err": err}
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
