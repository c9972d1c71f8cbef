"""What each kernel moves and computes: the roofline counts of K1–K8.

Each ``*_work`` function gives ``(bytes, float ops[, ...])`` of one launch
at one shape: the bytes the kernel must move (each input read once, each
output written once) and the operations it does on them.  ``chip_smoke.py``
turns them into the bounds of its ``kernels`` line, and the ``meta`` branch
of ``kernels/ops.py`` adds them to this module's tally for every launch it
stands in for, so a shape-only trace (``launch/costs.py``) counts the
kernels' work beside the aten products that ``FlopCounterMode`` sees.

``record`` / ``reset`` / ``totals`` keep that tally: per wrapper name, the
launches, bytes and float ops (3xTF32 products counted once: the useful
arithmetic, not the tensor cores' passes).  A launch whose work depends on
its data (K1's edges, the mapped K3/K4's slices) is counted with ``None``
for what a shape cannot say.  The CPU branch of a wrapper records its
plain version's call the same way, inside ``kernel``, so that a cost trace
of a CPU run counts the kernel's work and not the plain version's own
operations (``inside``).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager

# K7's backward takes its steps in chunks of this many
# (``csrc/rwkv6_scan_bwd.cu``: ``C``, and ``rwkv6_scan_bwd_saved`` = the
# chunks of a sequence); K6's backward saves its state every
# ``MAMBA_BWD_TILE`` steps and gives ``MAMBA_BWD_WIDTH`` channels to a block
# (``csrc/mamba_scan_bwd.cu``: ``TT``, ``CPB``, ``mamba_scan_bwd_layout``)
K7_BWD_CHUNK = 16
MAMBA_BWD_TILE, MAMBA_BWD_WIDTH = 8, 128


def minmax_relax_work(s, u, v, edges):
    """(bytes, int ops) of K1: prop (S, U) int32 read, the uint8 adjacency
    (U, V) read, the (S, V) int32 output written once; one min per
    (source, edge)."""
    return 4 * s * u + u * v + 4 * s * v, s * edges


def ell_superstep_work(s, n, k):
    """(bytes, int ops) of K8: the labels (S, n) int32 read, the other
    buffer read (the previous labels) and written, the (n, K) in-neighbour
    table and the out-degrees read once, the (S,) counters read and
    written; one max and one min per (source, neighbour slot)."""
    return 12 * s * n + 4 * n * k + 4 * n + 5 * 4 * s, 2 * s * n * k


def column_fingerprints_work(s, v):
    """(bytes, int ops) of K2: rel (S, V) and the four (S,) lanes read, the
    (3, V) fingerprints written; two compares per (row, column)."""
    return 4 * s * v + 4 * 4 * s + 3 * v * 4, 2 * s * v


def panel_update_work(m, k, n, esize, systems=1):
    """(bytes, flops) of dense K3 (``systems`` = 1) or K4 over ``systems``
    stacked slices: acc read and written, L and U read; 2 flops per
    multiply-add, ``esize`` bytes an element."""
    return (esize * systems * (2 * m * n + m * k + k * n),
            2 * systems * m * n * k)


def panel_update_mapped_work(hits, widths, outputs, u_entries):
    """(bytes, flops) of the mapped K3/K4 over one level's slices, float64
    storage: the L entries the maps hit (``hits``, one per slice), U, acc
    read and written; 2 flops per hit per column (``widths``, each
    slice's N)."""
    return (8 * (sum(hits) + u_entries + 2 * outputs),
            sum(2 * h * int(n) for h, n in zip(hits, widths)))


def attn_work(b, h, s, t, d, live=None, hkv=None, window=None, causal=True):
    """(bytes, useful float ops) of float32 attention over t keys: the live
    heads' q, the unique k and v (hkv heads) read once (with a window, only
    the keys some query sees) and the output (all h heads) written once;
    QK^T and PV over the visible (query, key) pairs of the live heads only:
    causal query i sees min(i + t - s + 1, window) keys, else all t."""
    live = h if live is None else live
    hkv = h if hkv is None else hkv
    window = window or t
    pairs = (_causal_pairs(s, t, window) if causal else s * t)
    keys = min(t, s - 1 + window) if causal else t
    return (4 * (b * live * s * d + b * h * s * d + 2 * b * hkv * keys * d),
            4 * d * pairs * b * live)


def _causal_pairs(s, t, window):
    """sum over i < s of min(i + t - s + 1, window), in closed form."""
    lo = t - s + 1                      # keys query 0 sees, unwindowed
    ramp = max(0, min(s, window - lo + 1))   # queries still below the window
    return ramp * lo + ramp * (ramp - 1) // 2 + (s - ramp) * window


def k5_bwd_work(b, h, live, hkv, s, t, d, *, causal, window):
    """(bytes, float ops) of K5's backward: q, o, dO of the live heads,
    the log-sum-exp and the unique k, v read once, dq (all H heads), dk
    and dv written once; 2.5 x the forward's operations (five S x T x D
    products over the visible pairs against two)."""
    _, flops = attn_work(b, h, s, t, d, live, hkv, window, causal)
    return (4 * (3 * b * live * s * d + b * h * s + 2 * b * hkv * t * d
                 + b * h * s * d + 2 * b * hkv * t * d), 2.5 * flops)


def rwkv6_work(b, l, h, k):
    """(bytes, float ops) of K7: r, k, v, w read and o written once, u,
    the state in and out; 5 flops per (t, key, value): k_i v_j, the FMA
    w_i S_ij + kv and the FMA r_i S_ij; and 5 per (t, value) for the bonus
    term, the scalar sum_i r_i u_i k_i (3 per key) times v_j added to the
    output (2 per value)."""
    return (4 * (5 * b * l * h * k + h * k + 2 * b * h * k * k),
            5 * b * l * h * k * k + 5 * b * l * h * k)


def rwkv6_bwd_work(b, l, h, k):
    """(bytes, tensor-core float ops as 3 TF32 products, CUDA-core float
    ops) of K7's backward in its chunked form (chunks of C steps): r, k, v,
    w, do read and dr, dk, dv, dw written once, u and du, the state and its
    upstream gradient read and dstate written; a chunk's products S_c
    DO^T, G_e V^T, Kt G_e and the two state updates (K^2 C multiply-adds
    each) and V DO^T, A DO (C^2 K each), each counted 3 times (3xTF32);
    on the CUDA cores, per key, the decay table and the W, dr and dw sums
    over the pairs s < t (8 flops a pair), A's pairs s <= t (2 K each),
    rowsum(G_e S_c) (2 K^2).  ``rwkv6_bwd_step_work`` is the step-by-step
    walk's count."""
    c = K7_BWD_CHUNK
    chunks = b * h * -(-l // c)
    pairs = c * (c - 1) // 2
    return (4 * (9 * b * l * h * k + 2 * h * k + 3 * b * h * k * k),
            3 * 2 * chunks * (5 * k * k * c + 2 * c * c * k),
            chunks * (k * 8 * pairs + 2 * k * (pairs + c) + 2 * k * k))


def rwkv6_bwd_step_work(b, l, h, k):
    """(bytes, float ops) of K7's backward as a step-by-step walk on the
    CUDA cores: 14 flops per (t, key, value) (the state S_{t-1} formed
    once, the FMAs of dr, dk and dw, G k_i and its sum for dv, G's
    update) and 10 per (t, key) for the bonus terms."""
    return (rwkv6_bwd_work(b, l, h, k)[0],
            14 * b * l * h * k * k + 10 * b * l * h * k)


def mamba_work(b, l, di, n):
    """(bytes, float ops, exponentials) of K6: x, dt read and y written
    once, B_t, C_t, A, D, the state in and out; 6 flops and one exp per
    (t, d, n), 3 flops per (t, d)."""
    return (4 * (3 * b * l * di + 2 * b * l * n + di * n + di
                 + 2 * b * di * n),
            6 * b * l * di * n + 3 * b * l * di, b * l * di * n)


def mamba_bwd_work(b, l, di, n):
    """(bytes, float ops, exponentials) of K6's backward: x, dt, dy read
    and dx, ddt written once, B_t, C_t read and dB, dC written, A, D and
    their gradients, h0 and the final state's gradient read and dh0
    written; 17 flops and one exp per (t, d, n) (the state h_{t-1} formed
    once, g's update, the decay's gradient, the terms of dB, dC, g . B,
    dA), 8 per (t, d)."""
    return (4 * (5 * b * l * di + 4 * b * l * n + 2 * di * n + 2 * di
                 + 3 * b * di * n),
            17 * b * l * di * n + 8 * b * l * di, b * l * di * n)


_LOCK = threading.Lock()
_TALLY: dict = defaultdict(lambda: {"launches": 0, "bytes": 0, "flops": 0})


def record(name: str, nbytes, flops) -> None:
    """One launch of wrapper ``name`` and its work (``None``: not known
    from shapes alone; the tally's entry then reads ``None`` too)."""
    with _LOCK:
        entry = _TALLY[name]
        entry["launches"] += 1
        for key, x in (("bytes", nbytes), ("flops", flops)):
            entry[key] = (None if x is None or entry[key] is None
                          else entry[key] + x)


_REGION = threading.local()


@contextmanager
def kernel(name: str, nbytes, flops):
    """``record`` one call of ``name``, and mark the ops run inside (a
    plain version's) as the kernel's own: ``inside()`` is True there."""
    record(name, nbytes, flops)
    depth = getattr(_REGION, "depth", 0)
    _REGION.depth = depth + 1
    try:
        yield
    finally:
        _REGION.depth = depth


def inside() -> bool:
    """True within a ``kernel`` region of this thread."""
    return getattr(_REGION, "depth", 0) > 0


def reset() -> None:
    with _LOCK:
        _TALLY.clear()


def totals() -> dict:
    """{wrapper name: {"launches", "bytes", "flops"}} since ``reset``."""
    with _LOCK:
        return {k: dict(v) for k, v in _TALLY.items()}
