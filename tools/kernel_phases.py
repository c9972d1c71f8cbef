#!/usr/bin/env python3
"""Where the cycles of K7's or K6's backward go, phase by phase, on one
card.

    python3 tools/kernel_phases.py k7bwd     # or k6bwd, or both

An edited copy of the committed source (``src/repro_torch/kernels/csrc/``)
gets a ``clock64()`` mark before (or after) each anchor in ``MARKS``:
thread 0 of each block adds the cycles since its previous mark to that
mark's phase.  The totals are written over a scratch buffer the kernel
no longer reads (K7: ``du_part``; K6: its own saved states), read back
and printed as cycles a chunk (K7, 16 steps) or a tile (K6, 8 steps), the
mean over the blocks, at ``chip_smoke.py``'s train shapes.  Thread 0's
marks include its waits at the block's barriers, so a phase that ends in
a barrier carries the other warps' lag.  The copies are built with the
port's ``nvcc`` flags into ``build/phases/`` (gitignored).  The kernel's
results are not checked (the scratch is overwritten); the marks add a few
instructions a phase.  Prints one JSON line per kernel, then the card's
name and power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "phases"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# kernel -> (source, [(anchor, phase, mark before the anchor)], the line
# after which the counters start, the line after which they are written,
# the write)
MARKS = {
    "k7bwd": ("rwkv6_scan_bwd", [
        ("    if (c + 1 == nc) break;  // the last chunk's steps are not "
         "needed\n    stage_f", "forward: state to the stage, bulk store",
         True),
        ("    __syncthreads();\n    const int fb = c % NFB;\n",
         "forward: copies issued, waited", True),
        ("    __syncthreads();\n    update_state(ktil, fseq(fb, 1));\n",
         "forward: Kt", True),
        ("    if (tid == 0) bulk_wait_read();  // the staged state is read\n",
         "forward: state update", True),
        ("  // sweep 2: back in time, chunk by chunk, G in st\n",
         "forward: barriers", True),
        ("    // phase 1: the decay tables, Y, X, M, and rowsum(G_e * S_c)\n",
         "copies, G_e to shared memory, barrier", True),
        ("    // Y = S_c DO^T and X = G_e V^T: a warp one 16-key row strip "
         "of one;\n", "decay tables", True),
        ("    if (owns) {  // this warp's part of rowsum(G_e * S_c), rows g "
         "and g + 8\n", "Y, X, M (tensor cores)", True),
        ("    // phase 2: the per-key recurrences (dr, dk, dw, du), A, and "
         "the\n", "rowsum(G_e S_c), barrier", True),
        ("      // W_t[s] for this thread's chains s = q + KT mm, and Q_t, "
         "back from\n", "per-key loads", True),
        ("    // A[t][s] = sum_i kap_s[t][i] r_s[i] (t < s), sum_i u_i k_t[i] "
         "r_t[i]\n", "per-key walk (dr, dk, dw)", True),
        ("    // dv = Kt G_e + A DO: a warp's 8-column tiles (Kt G_e here)\n",
         "A", True),
        ("    update_state(rtil, &in(QDO, buf, 0, 0));\n", "Kt G_e", True),
        ("    // phase 3: dv's A DO and the bonus, written\n",
         "G's update, barrier", True),
        ("    __syncthreads();  // this buffer and the tables are consumed\n",
         "A DO, dv written", True),
        ("    __syncthreads();  // this buffer and the tables are consumed\n",
         "end barrier", False),
    ], "  const int nc = (L + C - 1) / C;\n",
        "  if (q == 0) du_part[(size_t)bh * K + key] = du_acc;\n",
        "du_part[(size_t)bh * K + i_]"),
    "k6bwd": ("mamba_scan_bwd", [
        ("  // sweep 2: back in time, tile by tile\n", "forward sweep", True),
        ("    // the tile's states h_{t-1}, recomputed from the saved one "
         "into the\n", "copies installed, barriers, last tile's sums",
         True),
        ("#pragma unroll\n    for (int tt = TT - 1; tt >= 0; --tt) {\n"
         "      if (tt == TT - 3", "recompute", True),
        ("    __syncthreads();  // the warps' sums are in place\n", "walk",
         True),
        ("    // the block's partial of dB_t and dC_t: the warps in a fixed "
         "order\n", "barrier", True),
    ], "  const int nc = (L + TT - 1) / TT;\n",
        "    if (live[c]) part_d[(size_t)b * DI + d[c]] = dd[k];\n  }\n",
        "reinterpret_cast<float*>(my_chk - tid)[i_]"),
}


def instrument(kern):
    """The edited source and its phases' names."""
    source, marks, start, end, dst = MARKS[kern]
    text = (CSRC / f"{source}.cu").read_text()
    names = []
    for anchor, name, before in marks:
        if text.count(anchor) != 1:
            raise SystemExit(f"{kern}: the source no longer has {anchor!r}"
                             " once")
        mark = f"    PH({len(names)});\n"
        names.append(name)
        text = text.replace(anchor, mark + anchor if before
                            else anchor + mark)
    n = len(names)
    for line in (start, end):
        if text.count(line) < 1:
            raise SystemExit(f"{kern}: the source no longer has {line!r}")
    text = text.replace(start, start + (
        f"  long long T_[{n}] = {{0}};\n  long long tp_ = clock64();\n"
        "#define PH(i) do { if (threadIdx.x == 0) { const long long n_ = "
        "clock64(); T_[i] += n_ - tp_; tp_ = n_; } } while (0)\n"), 1)
    text = text.replace(end, end + (
        "  __syncthreads();\n  if (threadIdx.x == 0)\n"
        f"    for (int i_ = 0; i_ < {n}; ++i_) {dst} = (float)T_[i_];\n"))
    return text, names


def run_k7(torch, cs, fn):
    from repro_torch.kernels import _build, work

    b, l, h, k = cs.K7_SHAPES["prefill"]
    args = cs.scan_bwd_inputs(torch, "rwkv6", (b, l, h, k), zero_state=True,
                              seed=3)
    outs = [torch.empty_like(args[0]) for _ in range(4)]
    du, dstate = torch.zeros_like(args[4]), torch.empty_like(args[5])
    saved = _build.launcher("rwkv6_scan_bwd_saved")(l)
    chk = torch.empty(b * h * saved * k * k, device="cuda")
    du_part = torch.zeros((b, h, k), device="cuda")
    for _ in range(3):
        err = fn(*(t.data_ptr() for t in (*args, *outs, du, dstate, chk,
                                          du_part)),
                 b, l, h, k, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"k7bwd: launch error {err}")
    return du_part.reshape(b * h, k), -(-l // work.K7_BWD_CHUNK)


def run_k6(torch, cs, fn):
    from repro_torch.kernels import _build

    b, l, di, n = cs.K6_SHAPES["prefill"]
    args = cs.scan_bwd_inputs(torch, "mamba", (b, l, di, n), zero_state=True,
                              seed=3)
    x, dt, bt, ct, a, dsk, h0 = args[:7]
    layout = _build.launcher("mamba_scan_bwd_layout")
    tile, width = layout(0), layout(1)
    blocks = -(-di // width)
    outs = [torch.empty_like(x), torch.empty_like(dt), torch.zeros_like(bt),
            torch.zeros_like(ct), torch.zeros_like(a), torch.zeros_like(dsk),
            torch.empty_like(h0)]
    f32 = {"dtype": torch.float32, "device": "cuda"}
    chk = torch.empty(b * blocks * width * n * -(-l // tile), **f32)
    part_bc = torch.empty(blocks * b * l * 2 * n, **f32)
    part_a = torch.zeros((b, di, n), **f32)
    part_d = torch.empty((b, di), **f32)
    for _ in range(3):
        err = fn(*(t.data_ptr() for t in (*args, *outs, chk, part_bc,
                                          part_a, part_d)),
                 b, l, di, n, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"k6bwd: launch error {err}")
    # each block's saved states start at block * tiles * width * n floats
    tiles = -(-l // tile)
    return chk.reshape(b * blocks, tiles * width * n), tiles


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    for kern in argv or ["k7bwd", "k6bwd"]:
        text, names = instrument(kern)
        cu = OUT / f"{kern}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                "-o", str(so), str(cu)],
                               capture_output=True, text=True)
        if built.returncode:
            print(json.dumps({"kernel": kern,
                              "build_failed": built.stdout[-2000:]
                              + built.stderr[-2000:]}), flush=True)
            continue
        source = MARKS[kern][0]
        sig = _build.SIGNATURES[source]
        fn = getattr(ctypes.CDLL(str(so)), sig[1])
        fn.argtypes = list(sig[2])
        fn.restype = ctypes.c_int
        totals, steps = (run_k7 if kern == "k7bwd" else run_k6)(torch, cs,
                                                                  fn)
        mean = totals[:, :len(names)].double().mean(0).tolist()
        print(json.dumps({"kernel": kern, "per": "chunk" if kern == "k7bwd"
                          else "tile",
                          "cycles_thread0": {nm: round(t / steps)
                                             for nm, t in zip(names, mean)},
                          "sum": round(sum(mean) / steps)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
