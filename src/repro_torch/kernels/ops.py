"""Dispatch layer of the port's kernels: one wrapper per kernel, and the
port's one device policy (``resolve_device``: ``None`` is the card, and a
missing card raises instead of running on the CPU).

The rule is the tensor's device and nothing else.  For tensors on the CPU a
wrapper runs the kernel's plain version (``kernels/plain.py``); for CUDA
tensors it launches the hand-written kernel (``kernels/csrc/``) on the
current stream, or raises — a failed build or launch never falls back.
For ``meta`` tensors (a shape-only trace: ``launch/costs.py``,
``launch/dryrun.py``) it checks and allocates exactly as on the card —
outputs and scratch, empty — and launches nothing: it records one launch
of the kernel and its bytes and operations (``kernels/work.py``) in the
work tally, which a dry run reads.  ``meta`` is only ever asked for
explicitly.
Each wrapper validates device, dtype, shape and contiguity, allocates its
output, and counts its launches in ``<wrapper>.launches`` (incremented only
where the kernel is launched), so a run can show which kernels its path
went through.

========================  ============================================  ==
wrapper                   replaces (src/repro/kernels/)
========================  ============================================  ==
``minmax_relax``          gsofa_relax.py::minmax_relax_pallas           K1
``column_fingerprints``   supernode_fp.py::supernode_fp_pallas          K2
``panel_update``          panel_update.py::panel_update_pallas          K3
``panel_update_batched``  panel_update.py::panel_update_batched_pallas  K4
``panel_update_mapped``   panel_update.py::panel_update_batched_pallas  K4
``flash_attention``       flash_attention.py::flash_attention_pallas    K5
``flash_attention_backward``  none: K5's gradient (the train path)      K5
``mamba_scan``            ssm_scan.py::mamba_scan_pallas                K6
``mamba_scan_backward``   none: K6's gradient (the train path)          K6
``rwkv6_scan``            ssm_scan.py::rwkv6_scan_pallas                K7
``rwkv6_scan_backward``   none: K7's gradient (the train path)          K7
``ell_superstep``         none: the ELL fixpoint's superstep (jnp)      K8
========================  ============================================  ==

``panel_update_mapped`` is K3/K4 in the form the panel sweep launches: in
place in the packed store, L read through a static map, one launch per
dependency level (one slice is K3's role).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plain
from repro_torch.kernels import work

INF = plain.INF
_COUNT_LOCK = threading.Lock()


def resolve_device(device=None, *, meta: bool = False) -> torch.device:
    """``None`` -> the card.  Raises when CUDA is asked for and absent: the
    port never moves to the CPU on its own.  ``"meta"`` (shapes without
    memory, a dry run) only where the caller says it runs on shapes
    (``meta=True``: the model's parameters and caches); it is never a
    default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu") and not (meta and dev.type == "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}"
                         + (" (meta: only for a dry run's parameters and "
                            "caches)" if dev.type == "meta" else ""))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def _route(*tensors: torch.Tensor) -> str:
    """``"cpu"`` (the plain version), ``"cuda"`` (the kernel) or ``"meta"``
    (shapes only) for inputs on one device; raises for mixed or other
    devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"kernels run on 'cpu' (plain version), 'cuda' or "
                         f"'meta' (shapes only), got {dev}")
    return dev.type


def _plain(wrapper, counts, fn, *args, **kwargs):
    """The CPU branch: ``fn(*args, **kwargs)``, a plain version, recorded
    in the work tally as one call of ``wrapper``'s kernel with ``counts``
    = (bytes, float ops, ...); a cost trace counts those and skips the
    plain version's own operations (``work.kernel``)."""
    with work.kernel(wrapper.__name__, *counts[:2]):
        return fn(*args, **kwargs)


def _stand_in(wrapper, like: torch.Tensor, counts) -> bool:
    """On ``meta`` (``like`` a meta tensor), record one launch of
    ``wrapper``'s kernel in the work tally with ``counts()`` = (bytes,
    float ops, ...), and return True; else False.  Nothing is launched,
    so ``wrapper.launches`` stays as it was; ``counts`` is called only
    here, so the card's path computes nothing for a dry run."""
    if not like.is_meta:
        return False
    work.record(wrapper.__name__, *counts()[:2])
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")


def _launch(kernel: str, *args) -> None:
    err = _build.launcher(kernel)(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{err}")


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: the dynamic runtime's slots
    launch from several threads, so the increment takes a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def minmax_relax(prop: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """K1: (S, V) int32 ``min_u (adj[u, v] != 0 ? prop[s, u] : INF)`` for
    int32 ``prop`` (S, U) and uint8 ``adj`` (U, V).  On the card the output
    is filled with INF and the kernel lowers it with ``atomicMin``: two
    device ops, one launch counted."""
    if _route(prop, adj) == "cpu":
        s, u, v = prop.shape[0], adj.shape[0], adj.shape[-1]
        return _plain(minmax_relax, (work.minmax_relax_work(s, u, v, 0)[0],
                                     None), plain.minmax_relax_plain, prop,
                      adj)
    _check("prop", prop, torch.int32, 2)
    _check("adj", adj, torch.uint8, 2)
    s, u = prop.shape
    if adj.shape[0] != u:
        raise ValueError(f"prop {tuple(prop.shape)} and adj "
                         f"{tuple(adj.shape)} disagree on U")
    v = adj.shape[1]
    # the kernel lowers the entries its edges reach with atomicMin
    out = torch.full((s, v), INF, dtype=torch.int32, device=prop.device)
    # on meta the edges are unknown: the work tally takes none for the ops
    if s and u and v and not _stand_in(
            minmax_relax, prop,
            lambda: (work.minmax_relax_work(s, u, v, 0)[0], None)):
        _launch("minmax_relax", prop.data_ptr(), adj.data_ptr(),
                out.data_ptr(), s, u, v, _stream(prop))
        _count(minmax_relax)
    return out


def ell_superstep(labels: torch.Tensor, out: torch.Tensor,
                  in_ell: torch.Tensor, out_deg: torch.Tensor,
                  srcs: torch.Tensor, edges: torch.Tensor,
                  conv: torch.Tensor, flag: torch.Tensor, *,
                  offset: int, it: int) -> None:
    """K8: superstep ``it`` of the ELL fixpoint in one launch.  From the
    int32 ``labels`` (S, n) it writes the next labels into ``out`` (S, n),
    adds the frontier's out-degrees (``out_deg`` (n,)) to ``edges`` (S,),
    sets ``conv`` (S,) to ``it + 1`` on rows with a frontier and ``flag``
    (1,) to ``it + 1`` if any row has one; ``in_ell`` (n, K) is padded with
    n.  All int32, in place: ``labels`` and ``out`` are the two buffers of
    the Jacobi pair, and for ``it`` >= 1 ``out``, ``edges`` and ``conv``
    hold what superstep ``it - 1`` left (the kernel skips rows whose
    frontier was empty then)."""
    if _route(labels, out, in_ell, out_deg, srcs, edges, conv, flag) == "cpu":
        _plain(ell_superstep, work.ell_superstep_work(*labels.shape,
                                                       in_ell.shape[1]),
               plain.ell_superstep_plain, labels, out, in_ell, out_deg,
               srcs, edges, conv, flag, offset=offset, it=it)
        return
    for name, t, ndim in (("labels", labels, 2), ("out", out, 2),
                          ("in_ell", in_ell, 2), ("out_deg", out_deg, 1),
                          ("srcs", srcs, 1), ("edges", edges, 1),
                          ("conv", conv, 1), ("flag", flag, 1)):
        _check(name, t, torch.int32, ndim)
    s, n = labels.shape
    k = in_ell.shape[1]
    if (out.shape != labels.shape or in_ell.shape[0] != n
            or out_deg.shape[0] != n or flag.shape[0] != 1
            or any(t.shape[0] != s for t in (srcs, edges, conv))):
        raise ValueError(
            f"ell_superstep: labels {tuple(labels.shape)}, out "
            f"{tuple(out.shape)}, in_ell {tuple(in_ell.shape)}, out_deg "
            f"{tuple(out_deg.shape)}, srcs/edges/conv {tuple(srcs.shape)}/"
            f"{tuple(edges.shape)}/{tuple(conv.shape)}, flag "
            f"{tuple(flag.shape)} do not fit (S, n), (n, K), (S,), (1,)")
    if not labels.is_meta and labels.data_ptr() == out.data_ptr():
        raise ValueError("ell_superstep: labels and out must be two buffers")
    if not (-INF <= offset and offset + n <= INF and 0 <= it < INF):
        raise ValueError(f"ell_superstep: offset {offset} + n {n} leaves "
                         f"int32, or superstep {it} is out of range")
    if s and n and k and not _stand_in(
            ell_superstep, labels, lambda: work.ell_superstep_work(s, n, k)):
        _launch("ell_superstep", labels.data_ptr(), out.data_ptr(),
                in_ell.data_ptr(), out_deg.data_ptr(), srcs.data_ptr(),
                edges.data_ptr(), conv.data_ptr(), flag.data_ptr(), s, n, k,
                offset, it, _stream(labels))
        _count(ell_superstep)


def column_fingerprints(rel: torch.Tensor, src: torch.Tensor,
                        m1: torch.Tensor, m2: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """K2: (3, V) int32 per-column fingerprints (count, wrapping sum of
    ``m1``, xor of ``m2``) over rows with ``rel < v``, ``src > v`` and
    ``valid != 0``; ``rel`` (S, V), the others (S,), all int32."""
    if _route(rel, src, m1, m2, valid) == "cpu":
        return _plain(column_fingerprints,
                      work.column_fingerprints_work(*rel.shape),
                      plain.column_fingerprints_plain, rel, src, m1, m2,
                      valid)
    _check("rel", rel, torch.int32, 2)
    s, v = rel.shape
    for name, t in (("src", src), ("m1", m1), ("m2", m2), ("valid", valid)):
        _check(name, t, torch.int32, 1)
        if t.shape[0] != s:
            raise ValueError(f"{name} has {t.shape[0]} rows, rel has {s}")
    out = torch.zeros((3, v), dtype=torch.int32, device=rel.device)
    if s and v and not _stand_in(
            column_fingerprints, rel,
            lambda: work.column_fingerprints_work(s, v)):
        _launch("column_fingerprints", rel.data_ptr(), src.data_ptr(),
                m1.data_ptr(), m2.data_ptr(), valid.data_ptr(),
                out.data_ptr(), s, v, _stream(rel))
        _count(column_fingerprints)
    return out


def _panel_args(acc, l_panel, u_panel, ndim: int):
    if acc.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"panel updates take float32 or float64, got "
                         f"{acc.dtype}")
    for name, t in (("acc", acc), ("l_panel", l_panel),
                    ("u_panel", u_panel)):
        _check(name, t, acc.dtype, ndim)
    *lead, m, n = acc.shape
    k = l_panel.shape[-1]
    if (tuple(l_panel.shape) != (*lead, m, k)
            or tuple(u_panel.shape) != (*lead, k, n)):
        raise ValueError(f"panel shapes disagree: acc {tuple(acc.shape)}, "
                         f"l_panel {tuple(l_panel.shape)}, u_panel "
                         f"{tuple(u_panel.shape)}")
    return m, n, k


PANEL_THREADS = 128            # K3/K4's block: one output per thread
PANEL_TILE_INTS = 10           # a mapped tile record's int32 fields


def _tile_shapes(n: np.ndarray, k: np.ndarray):
    """(TC, BK) arrays of ``panel_tile`` for arrays of N and K."""
    large = k > 16
    tc = np.ones_like(n)
    while (tc < n).any():
        tc = np.where(tc < n, 2 * tc, tc)
    return np.clip(tc, 4, np.where(large, 32, 64)), np.where(large, 32, 16)


def panel_tile(n: int, k: int) -> tuple:
    """(TC, BK) of the K3/K4 tile for a slice of N columns and depth K: TC
    outputs along N (the power of two >= N in [4, 64], [4, 32] for deep
    slices) times ``PANEL_THREADS // TC`` along M; ``BK`` the K chunk
    staged at a time, 16 for K <= 16 and 32 beyond
    (``csrc/panel_update.cu``)."""
    tc, bk = _tile_shapes(np.array([n]), np.array([k]))
    return int(tc[0]), int(bk[0])


def padded_gemm_shape(m, k, n):
    """Padded ``(M, K, N)`` that the mapped K3/K4 works through for a
    logical ``m x k @ k x n`` update: M up to a multiple of the tile's rows
    (``PANEL_THREADS // TC``), N up to a multiple of TC, K up to a multiple
    of BK, with (TC, BK) ``panel_tile``'s.  The cost model charges this
    shape for the kernel backend.  Scalars or numpy arrays (vectorised over
    candidate partitions); a zero dimension gives (0, 0, 0) — such an
    update is never launched."""
    m_, k_, n_ = (np.asarray(x, dtype=np.int64) for x in (m, k, n))
    tc, bk = _tile_shapes(n_, k_)
    tr = PANEL_THREADS // tc
    dead = (m_ == 0) | (k_ == 0) | (n_ == 0)
    mp, kp, np_ = (np.where(dead, 0, -(-x // t) * t)
                   for x, t in ((m_, tr), (k_, bk), (n_, tc)))
    if np.isscalar(m) and np.isscalar(k) and np.isscalar(n):
        return int(mp), int(kp), int(np_)
    return mp, kp, np_


def mapped_tiles(slices) -> np.ndarray:
    """(T, ``PANEL_TILE_INTS``) int32 tile records of the mapped update
    for ``slices``, rows ``(acc_off, map_off, u_off, M, N, K)``: each
    slice's tiles in row-major tile order, each record ``(acc_off, map_off,
    u_off, M, N, K, m0, n0, TC, BK)`` with (TC, BK) ``panel_tile``'s.  A
    slice's first record, ``m0 = n0 = 0``, stands for the whole slice in
    the plain version."""
    s = np.asarray(slices, dtype=np.int64).reshape(-1, 6)
    m, n, k = s[:, 3], s[:, 4], s[:, 5]
    tc, bk = _tile_shapes(n, k)
    tr = PANEL_THREADS // tc
    tiles_n = -(-n // tc)
    count = -(-m // tr) * tiles_n
    t = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)

    def rep(x):
        return np.repeat(x, count)

    return np.column_stack([
        np.repeat(s, count, axis=0), t // rep(tiles_n) * rep(tr),
        t % rep(tiles_n) * rep(tc), rep(tc), rep(bk)]).astype(np.int32)


def _dense_panel_launch(wrapper, acc, l_panel, u_panel, b: int, m: int,
                        n: int, k: int, batched: bool) -> torch.Tensor:
    """K3 (``batched`` False) or K4 over b slices into a new tensor,
    counted as one launch of ``wrapper``."""
    out = torch.empty_like(acc)
    tc, bk = panel_tile(n, k)
    tiles = -(-m // (PANEL_THREADS // tc)) * -(-n // tc)
    if tiles * b > 2 ** 31 - 1:
        raise ValueError(f"panel update of {b} x ({m}, {n}) takes {tiles * b}"
                         f" blocks, more than a grid holds")
    if _stand_in(wrapper, acc, lambda: work.panel_update_work(
            m, k, n, acc.element_size(), b)):
        return out
    _launch("panel_update", acc.data_ptr(), l_panel.data_ptr(),
            u_panel.data_ptr(), out.data_ptr(), b, m, n, k, tc, bk,
            int(batched), int(acc.dtype == torch.float64), _stream(acc))
    _count(wrapper)
    return out


def panel_update(acc: torch.Tensor, l_panel: torch.Tensor,
                 u_panel: torch.Tensor) -> torch.Tensor:
    """K3: (M, N) ``acc - l_panel @ u_panel`` in true float32, or in
    float64 when all three are float64; an empty M, N or K returns
    ``acc``."""
    if _route(acc, l_panel, u_panel) == "cpu":
        if 0 in acc.shape or l_panel.shape[-1] == 0:
            return acc
        (m, n), k = acc.shape, l_panel.shape[-1]
        return _plain(panel_update, work.panel_update_work(
            m, k, n, acc.element_size()), plain.panel_update_plain, acc,
            l_panel, u_panel)
    m, n, k = _panel_args(acc, l_panel, u_panel, 2)
    if m == 0 or n == 0 or k == 0:
        return acc
    return _dense_panel_launch(panel_update, acc, l_panel, u_panel, 1, m, n,
                               k, False)


def panel_update_batched(acc: torch.Tensor, l_panel: torch.Tensor,
                         u_panel: torch.Tensor) -> torch.Tensor:
    """K4: (B, M, N) stacked K3 updates in one launch (float32 or
    float64); each slice is bitwise equal to K3 on that slice (same kernel
    body, same K order)."""
    if _route(acc, l_panel, u_panel) == "cpu":
        if 0 in acc.shape or l_panel.shape[-1] == 0:
            return acc
        (b, m, n), k = acc.shape, l_panel.shape[-1]
        return _plain(panel_update_batched, work.panel_update_work(
            m, k, n, acc.element_size(), b), plain.panel_update_batched_plain,
            acc, l_panel, u_panel)
    m, n, k = _panel_args(acc, l_panel, u_panel, 3)
    b = acc.shape[0]
    if b == 0 or m == 0 or n == 0 or k == 0:
        return acc
    return _dense_panel_launch(panel_update_batched, acc, l_panel, u_panel,
                               b, m, n, k, True)


PANEL_MAX_SYSTEMS = 65535      # the mapped update's system axis (gridDim.y)


def _system_strides(flat: torch.Tensor, u: torch.Tensor, systems: int,
                    flat_stride, u_stride):
    """(flat_stride, u_stride) with their defaults (an equal share of
    ``flat`` / ``u`` per system), checked against the mapped update's
    limits: 1 <= systems <= ``PANEL_MAX_SYSTEMS``, every system's run
    inside its buffer, and int32 offsets within a system."""
    if not 1 <= systems <= PANEL_MAX_SYSTEMS:
        raise ValueError(f"systems must lie in [1, {PANEL_MAX_SYSTEMS}], got "
                         f"{systems}")
    fs = flat.numel() // systems if flat_stride is None else int(flat_stride)
    us = u.numel() // systems if u_stride is None else int(u_stride)
    if fs < 0 or us < 0 or systems * fs > flat.numel() \
            or systems * us > u.numel():
        raise ValueError(f"{systems} systems of flat_stride {fs} and "
                         f"u_stride {us} do not fit flat ({flat.numel()}) "
                         f"and u ({u.numel()})")
    if fs >= 2 ** 31:
        raise ValueError(f"the mapped panel update addresses each system's "
                         f"store with int32 offsets; this store has {fs} "
                         f"entries a system")
    return fs, us


def panel_update_mapped(flat: torch.Tensor, u: torch.Tensor,
                        lmap: torch.Tensor, tiles: torch.Tensor, *,
                        u_shift: int = 0, f32: bool = False,
                        systems: int = 1, flat_stride=None,
                        u_stride=None) -> None:
    """K3/K4 in place in a packed store: for every slice of the tile
    records ``tiles`` (``mapped_tiles``), ``acc -= L @ U`` where acc is the
    (M, N) row-major run of ``flat`` at acc_off, ``L[i, k] =
    flat[lmap[map_off + i*K + k]]`` (-1: an exact zero) and U the (K, N)
    run of ``u`` at ``u_off - u_shift``.  ``flat`` and ``u`` are float64,
    ``lmap`` and ``tiles`` int32; ``f32`` rounds acc, L and U to float32
    once each, runs the product in float32 and stores the widened result
    (the kernel backend).  On the card the whole set is one launch; acc
    must not overlap any L entry (the sweep's L lies in earlier levels).

    ``systems`` > 1 runs the same records on each of ``systems`` stores of
    one structure in the same launch: system s's store is the run of
    ``flat_stride`` entries at ``s * flat_stride`` and its U buffer the run
    of ``u`` at ``s * u_stride`` (defaults: equal shares).  Each system's
    result is bitwise the ``systems=1`` call on that system alone; offsets
    are int32 within a system, so only ``flat_stride`` must stay below
    2^31, not the batch."""
    fs, us = _system_strides(flat, u, systems, flat_stride, u_stride)
    if _route(flat, u, lmap, tiles) == "cpu":
        _plain(panel_update_mapped, (None, None),
               plain.panel_update_mapped_plain, flat, u, lmap, tiles,
               u_shift=u_shift, f32=f32, systems=systems, flat_stride=fs,
               u_stride=us)
        return
    for name, t, dtype, ndim in (("flat", flat, torch.float64, 1),
                                 ("u", u, torch.float64, 1),
                                 ("lmap", lmap, torch.int32, 1),
                                 ("tiles", tiles, torch.int32, 2)):
        _check(name, t, dtype, ndim)
    if tiles.shape[1] != PANEL_TILE_INTS:
        raise ValueError(f"tiles must be (T, {PANEL_TILE_INTS}) records, got "
                         f"{tuple(tiles.shape)}")
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        return
    if n_tiles > 2 ** 31 - 1:
        raise ValueError(f"{n_tiles} tiles are more than a grid holds")
    # the slices' shapes are data (the tile records): no work on meta
    if _stand_in(panel_update_mapped, flat, lambda: (None, None)):
        return
    _launch("panel_update_mapped", flat.data_ptr(), u.data_ptr(),
            lmap.data_ptr(), tiles.data_ptr(), n_tiles, int(u_shift),
            int(f32), int(systems), fs, us, _stream(flat))
    _count(panel_update_mapped)


def panel_update_empty(blocks: int, device) -> None:
    """An empty kernel of ``blocks`` blocks of ``PANEL_THREADS`` on
    ``device``'s current stream: the device time of a launch, the floor
    under K3/K4's small shapes.  Not counted: it computes nothing."""
    _launch("panel_update_empty", int(blocks),
            torch.cuda.current_stream(device).cuda_stream)


FLASH_HEAD_DIMS = (16, 64, 128, 256)   # K5's instantiations of D
FLASH_MAX_GROUP = 64              # query heads per KV head on the card
FLASH_DECODE_CHUNK = 64           # keys per block of K5's decode kernel


def _attention_shapes(q, k, v, causal: bool, kv_len, live_heads, window):
    """Checks K5's shapes; returns (kv_len, live_heads, window) with their
    defaults (T, H, 0: none) filled in."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"attention takes q (B, H, S, D) and k, v "
                         f"(B, Hkv, T, D), got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on B or D")
    kv_len = t if kv_len is None else int(kv_len)
    live = h if live_heads is None else int(live_heads)
    if not 1 <= live <= h or hkv < 1 or live % hkv:
        raise ValueError(f"live_heads={live} must lie in [1, H={h}] and be "
                         f"a multiple of the {hkv} KV heads (q {tuple(q.shape)}"
                         f" and k {tuple(k.shape)} disagree on the heads)")
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len={kv_len} must lie in [1, T={t}]")
    if causal and kv_len < s:
        raise ValueError(f"causal attention needs T >= S (the queries are "
                         f"the last S of kv_len positions), got S={s}, "
                         f"kv_len={kv_len}")
    window = 0 if window is None else int(window)
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window} must be >= 1 and causal (the "
                         f"reference's sliding window), or None")
    return kv_len, live, window


def _rows_16b(t: torch.Tensor) -> bool:
    """Unit stride along D, and every row of t 16-byte aligned."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per == 0 for st in t.stride()[:-1]))


def _card_attention(q, k, v, live: int, what: str):
    """K5's limits on the card: float32 or bfloat16 throughout, D one of
    ``FLASH_HEAD_DIMS``, at most ``FLASH_MAX_GROUP`` query heads a KV
    head, grid limits."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{what} is built for D in {FLASH_HEAD_DIMS}, got "
                         f"D={d}")
    if live // hkv > FLASH_MAX_GROUP:
        raise ValueError(f"{what} takes at most {FLASH_MAX_GROUP} query "
                         f"heads per KV head, got {live // hkv}")
    if s > 64 * 65535 or b > 65535:
        raise ValueError(f"{what} takes at most {64 * 65535} queries and "
                         f"65535 sequences, got S={s}, B={b}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_len: int | None = None,
                    live_heads: int | None = None,
                    window: int | None = None, return_lse: bool = False):
    """K5: (B, H, S, D) online-softmax attention of q over the first
    ``kv_len`` (default T) rows of k, v (B, Hkv, T, D), float32 or
    bfloat16, accumulated in float32, returned in q's dtype.

    Query head ``h < live_heads`` (default H) attends to KV head
    ``h // (live_heads // Hkv)`` (``jnp.repeat`` order); heads
    ``>= live_heads`` come out exactly zero (the reference's zero-padded
    heads).  Causal queries are the last S of kv_len positions: query s
    sees keys ``<= s + (kv_len - S)``, and with a ``window`` (causal only)
    just the last ``window`` of them: keys ``> s + (kv_len - S) - window``
    (the reference's sliding-window mask).  ``scale`` defaults to
    ``D ** -0.5``.  On the card q, k and v are read in place through their
    strides (unit stride along D, 16-byte aligned rows; anything else is
    copied first), D is one of ``FLASH_HEAD_DIMS`` and a KV head serves at
    most ``FLASH_MAX_GROUP`` query heads; the result is a (B, H, S, D) view
    of a (B, S, H, D) tensor, so merging the heads is free.  With
    ``return_lse`` it returns ``(out, lse)``: lse the float32 (B, H, S)
    log-sum-exp of the scaled scores in base 2 (0 for padded heads), which
    ``flash_attention_backward`` takes; the prefill kernel writes it (also
    at S = 1), and ``out`` is bitwise the same as without it."""
    kv_len, live, window = _attention_shapes(q, k, v, causal, kv_len,
                                             live_heads, window)
    if _route(q, k, v) == "cpu":
        b, h, s, d = q.shape
        return _plain(flash_attention, work.attn_work(
            b, h, s, kv_len, d, live, k.shape[1], window or None, causal),
            plain.flash_attention_plain, q, k, v, causal=causal, scale=scale,
            kv_len=kv_len, live_heads=live, window=window or None,
            return_lse=return_lse)
    _card_attention(q, k, v, live, "flash_attention")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    q, k, v = (t if _rows_16b(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b * h == 0 or s == 0:
        return (out, lse) if return_lse else out
    part = None
    if s == 1 and not return_lse:  # the decode kernel's per-chunk results
        read = min(kv_len, window) if window else kv_len
        chunks = -(-read // FLASH_DECODE_CHUNK)
        part = torch.empty((b, live, chunks, d + 2), dtype=torch.float32,
                           device=q.device)
    if _stand_in(flash_attention, q, lambda: work.attn_work(
            b, h, s, kv_len, d, live, hkv, window or None, causal)):
        return (out, lse) if return_lse else out
    _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), 0 if part is None else part.data_ptr(),
            0 if lse is None else lse.data_ptr(), b, h, hkv, s, kv_len, live,
            d, int(causal), window,
            d ** -0.5 if scale is None else float(scale),
            int(q.dtype == torch.bfloat16), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], _stream(q))
    _count(flash_attention)
    return (out, lse) if return_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, scale: float | None = None,
                             live_heads: int | None = None,
                             window: int | None = None):
    """K5's backward: (dq (B, H, S, D), dk, dv (B, Hkv, T, D)) of
    ``flash_attention(q, k, v, ...)`` over all T keys for the upstream
    ``do`` (B, H, S, D), from its output ``o`` and its ``return_lse``
    log-sum-exp ``lse`` (float32 (B, H, S)); the same keywords, shape
    checks and device rule as ``flash_attention``, results in the inputs'
    dtype.  dq of the heads ``>= live_heads`` is exactly zero and they add
    nothing to dk, dv; dk and dv sum over each KV head's query heads.  On
    the card: a delta pass, then one kernel for dk and dv and one for dq,
    no atomics, so two calls on the same inputs agree bitwise; the
    results are (B, S, ., D) tensors seen as (B, ., S, D).  Where a
    kernel's grid would not fill the card (dq: a short query set; dk/dv:
    few KV heads) its blocks split their walk into chunks (the kernel
    library says how many) and float32 scratch of the chunks' partial sums
    is added in a fixed order."""
    _, live, window = _attention_shapes(q, k, v, causal, None, live_heads,
                                        window)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape "
                             f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    hkv, t_len = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, h, s)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if _route(q, k, v, o, do, lse) == "cpu":
        return _plain(flash_attention_backward, work.k5_bwd_work(
            b, h, live, hkv, s, t_len, d, causal=causal,
            window=window or None), plain.flash_attention_backward_plain,
            q, k, v, o, do, lse, causal=causal, scale=scale, live_heads=live,
            window=window or None)
    _card_attention(q, k, v, live, "flash_attention_backward")
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    q, k, v, o, do = (x if _rows_16b(x) else x.contiguous()
                      for x in (q, k, v, o, do))
    lse = lse.contiguous()

    def grad(heads, rows):
        return torch.empty((b, rows, heads, d), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = grad(h, s), grad(hkv, t_len), grad(hkv, t_len)
    if b * h == 0 or s == 0 or t_len == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, live, s), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    if q.is_meta:      # the split walks follow the card's occupancy: none
        q_chunks = kv_chunks = 1
    else:
        chunks = _build.launcher("flash_attention_bwd_chunks")
        q_chunks, kv_chunks = (chunks(b, hkv, live, s, t_len, d, bf16, kv)
                               for kv in (0, 1))
    if min(q_chunks, kv_chunks) < 1:
        raise RuntimeError(f"flash_attention_bwd_chunks failed: cudaError_t "
                           f"{-min(q_chunks, kv_chunks)}")
    f32 = {"dtype": torch.float32, "device": q.device}
    part_q = (torch.empty((q_chunks, b, h, s, d), **f32) if q_chunks > 1
              else None)
    part_kv = (torch.empty((2, kv_chunks, b, hkv, t_len, d), **f32)
               if kv_chunks > 1 else None)
    if _stand_in(flash_attention_backward, q, lambda: work.k5_bwd_work(
            b, h, live, hkv, s, t_len, d, causal=causal,
            window=window or None)):
        return dq, dk, dv
    _launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(0 if x is None else x.data_ptr() for x in (part_q, part_kv)),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, t_len,
            live, d, int(causal), window, q_chunks, kv_chunks,
            d ** -0.5 if scale is None else float(scale), bf16,
            *(st for x in (q, k, v, o, do, dq, dk, dv)
              for st in x.stride()[:3]), _stream(q))
    _count(flash_attention_backward)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K5 with its gradient: the forward runs ``flash_attention`` with the
    log-sum-exp and saves q, k, v, the output and the log-sum-exp; the
    backward runs ``flash_attention_backward``.  On the CPU both are the
    plain versions, on the card both are kernels; a failed build or
    launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, live_heads, window):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   live_heads=live_heads, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = {"causal": causal, "scale": scale,
                  "live_heads": live_heads, "window": window}
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, lse,
                                              **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          live_heads: int | None = None,
                          window: int | None = None) -> torch.Tensor:
    """``flash_attention`` over all T keys, differentiable in q, k and v
    through K5's backward (``FlashAttention``): the train path's
    attention."""
    return FlashAttention.apply(q, k, v, causal, scale, live_heads, window)


RWKV6_HEAD_SIZES = (16, 64)   # K7's instantiations of K
MAMBA_STATE_SIZES = (4, 16)   # K6's instantiations of N


def _same_shapes(names: str, *tensors: torch.Tensor):
    shapes = {tuple(t.shape) for t in tensors}
    if len(shapes) != 1:
        raise ValueError(f"{names} must share one shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")


def _rwkv6_shapes(fn: str, r, k, v, w, u, state):
    """(B, L, H, K) of K7's inputs; raises ``ValueError`` where they
    disagree."""
    if r.dim() != 4:
        raise ValueError(f"{fn} takes r, k, v, w (B, L, H, K), got "
                         f"{tuple(r.shape)}")
    _same_shapes("r, k, v, w", r, k, v, w)
    b, l, h, kk = r.shape
    if tuple(u.shape) != (h, kk) or tuple(state.shape) != (b, h, kk, kk):
        raise ValueError(f"{fn}: r {tuple(r.shape)} needs u {(h, kk)} "
                         f"and state {(b, h, kk, kk)}, got u "
                         f"{tuple(u.shape)} and state {tuple(state.shape)}")
    return b, l, h, kk


def _card_scan(fn: str, sizes: tuple, size: int, **tensors):
    """The card's rule for a scan's inputs: contiguous float32, a state
    size the kernel is instantiated for, and for K6 at most 65535
    sequences (its grid's y)."""
    for name, t in tensors.items():
        _check(name, t, torch.float32, t.dim())
    axis = "K" if "rwkv6" in fn else "N"
    if size not in sizes:
        raise ValueError(f"{fn} is built for {axis} in {sizes}, got "
                         f"{axis}={size}")
    rows = next(iter(tensors.values())).shape[0]
    if axis == "N" and rows > 65535:
        raise ValueError(f"{fn} takes at most 65535 sequences (grid y), "
                         f"got {rows}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: the rwkv6 recurrence ``o_t = r_t (S + diag(u) k_t^T v_t)``,
    ``S <- diag(w_t) S + k_t^T v_t`` from ``state``, float32.

    r, k, v, w (B, L, H, K); u (H, K); state (B, H, K, K) keyed
    [key, value].  Returns (o (B, L, H, K), the final state) as new
    tensors: ``state`` is not written.  K is one of ``RWKV6_HEAD_SIZES``
    on the card."""
    b, l, h, kk = _rwkv6_shapes("rwkv6_scan", r, k, v, w, u, state)
    if _route(r, k, v, w, u, state) == "cpu":
        return _plain(rwkv6_scan, work.rwkv6_work(b, l, h, kk),
                      plain.rwkv6_scan_plain, r, k, v, w, u, state)
    _card_scan("rwkv6_scan", RWKV6_HEAD_SIZES, kk, r=r, k=k, v=v, w=w, u=u,
               state=state)
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    if b * h == 0 or _stand_in(rwkv6_scan, r,
                               lambda: work.rwkv6_work(b, l, h, kk)):
        return o, s_out
    _launch("rwkv6_scan", r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), state.data_ptr(), o.data_ptr(),
            s_out.data_ptr(), b, l, h, kk, _stream(r))
    _count(rwkv6_scan)
    return o, s_out


def _mamba_shapes(fn: str, x, dt, b_t, c_t, a, d_skip, h0):
    """(B, L, di, N) of K6's inputs; raises ``ValueError`` where they
    disagree."""
    if x.dim() != 3 or b_t.dim() != 3:
        raise ValueError(f"{fn} takes x, dt (B, L, di) and b_t, c_t "
                         f"(B, L, N), got x {tuple(x.shape)}, b_t "
                         f"{tuple(b_t.shape)}")
    _same_shapes("x, dt", x, dt)
    _same_shapes("b_t, c_t", b_t, c_t)
    b, l, di = x.shape
    n = b_t.shape[2]
    if (tuple(b_t.shape[:2]) != (b, l) or tuple(a.shape) != (di, n)
            or tuple(d_skip.shape) != (di,)
            or tuple(h0.shape) != (b, di, n)):
        raise ValueError(f"{fn}: x {tuple(x.shape)} and b_t "
                         f"{tuple(b_t.shape)} need a {(di, n)}, d_skip "
                         f"{(di,)} and h0 {(b, di, n)}, got a "
                         f"{tuple(a.shape)}, d_skip {tuple(d_skip.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    return b, l, di, n


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor,
               c_t: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: the selective scan ``h <- exp(dt_t A) * h + (dt_t x_t) (x) B_t``,
    ``y_t = h . C_t + D x_t`` from ``h0``, float32.

    x, dt (B, L, di); b_t, c_t (B, L, N); a (di, N); d_skip (di,); h0
    (B, di, N).  Returns (y (B, L, di), the final state) as new tensors:
    ``h0`` is not written.  N is one of ``MAMBA_STATE_SIZES`` on the
    card."""
    b, l, di, n = _mamba_shapes("mamba_scan", x, dt, b_t, c_t, a, d_skip,
                                h0)
    if _route(x, dt, b_t, c_t, a, d_skip, h0) == "cpu":
        return _plain(mamba_scan, work.mamba_work(b, l, di, n),
                      plain.mamba_scan_plain, x, dt, b_t, c_t, a, d_skip, h0)
    _card_scan("mamba_scan", MAMBA_STATE_SIZES, n, x=x, dt=dt, b_t=b_t,
               c_t=c_t, a=a, d_skip=d_skip, h0=h0)
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    if b * di == 0 or _stand_in(mamba_scan, x,
                                lambda: work.mamba_work(b, l, di, n)):
        return y, h_out
    _launch("mamba_scan", x.data_ptr(), dt.data_ptr(), b_t.data_ptr(),
            c_t.data_ptr(), a.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), b, l, di, n, _stream(x))
    _count(mamba_scan)
    return y, h_out


def _upstream(name: str, got: torch.Tensor, like: torch.Tensor):
    if tuple(got.shape) != tuple(like.shape):
        raise ValueError(f"{name} {tuple(got.shape)} must have the shape "
                         f"{tuple(like.shape)}")


def rwkv6_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state: torch.Tensor, do: torch.Tensor,
                        ds_final: torch.Tensor):
    """K7's backward: (dr, dk, dv, dw (B, L, H, K), du (H, K), dstate (B,
    H, K, K)) of ``rwkv6_scan(r, k, v, w, u, state)`` for the upstream
    ``do`` of its output and ``ds_final`` of its final state, float32 new
    tensors; the forward's shape checks and device rule.  On the card the
    kernel first runs the recurrence again, saving the state every few
    steps to scratch, then walks back; du is summed over B in a fixed
    order and nothing uses atomics, so two calls agree bitwise."""
    b, l, h, kk = _rwkv6_shapes("rwkv6_scan_backward", r, k, v, w, u, state)
    _upstream("do", do, r)
    _upstream("ds_final", ds_final, state)

    def counts():
        nbytes, tc_ops, alu_ops = work.rwkv6_bwd_work(b, l, h, kk)
        return nbytes, tc_ops // 3 + alu_ops    # 3xTF32 products once

    if _route(r, k, v, w, u, state, do, ds_final) == "cpu":
        return _plain(rwkv6_scan_backward, counts(),
                      plain.rwkv6_scan_backward_plain, r, k, v, w, u, state,
                      do, ds_final)
    _card_scan("rwkv6_scan_backward", RWKV6_HEAD_SIZES, kk, r=r, k=k, v=v,
               w=w, u=u, state=state, do=do, ds_final=ds_final)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, dstate = torch.zeros_like(u), torch.empty_like(state)
    if b * h == 0:
        return dr, dk, dv, dw, du, dstate
    saved = (-(-l // work.K7_BWD_CHUNK) if r.is_meta
             else _build.launcher("rwkv6_scan_bwd_saved")(l))
    f32 = {"dtype": torch.float32, "device": r.device}
    chk = torch.empty(b * h * saved * kk * kk, **f32)
    du_part = torch.empty((b, h, kk), **f32)
    if _stand_in(rwkv6_scan_backward, r, counts):
        return dr, dk, dv, dw, du, dstate
    _launch("rwkv6_scan_bwd", *(t.data_ptr() for t in (
        r, k, v, w, u, state, do, ds_final, dr, dk, dv, dw, du, dstate, chk,
        du_part)), b, l, h, kk, _stream(r))
    _count(rwkv6_scan_backward)
    return dr, dk, dv, dw, du, dstate


def mamba_scan_backward(x: torch.Tensor, dt: torch.Tensor,
                        b_t: torch.Tensor, c_t: torch.Tensor,
                        a: torch.Tensor, d_skip: torch.Tensor,
                        h0: torch.Tensor, dy: torch.Tensor,
                        dh_final: torch.Tensor):
    """K6's backward: (dx, ddt (B, L, di), db, dc (B, L, N), da (di, N),
    dd_skip (di,), dh0 (B, di, N)) of ``mamba_scan(x, dt, b_t, c_t, a,
    d_skip, h0)`` for the upstream ``dy`` of its output and ``dh_final``
    of its final state, float32 new tensors; the forward's shape checks and
    device rule.  On the card the kernel first runs the recurrence again,
    saving the state every few steps to scratch, then walks back; dB and dC
    (sums over di) and da, dd_skip (sums over B) are partials added in a
    fixed order, and nothing uses atomics, so two calls agree bitwise."""
    b, l, di, n = _mamba_shapes("mamba_scan_backward", x, dt, b_t, c_t, a,
                                d_skip, h0)
    _upstream("dy", dy, x)
    _upstream("dh_final", dh_final, h0)
    if _route(x, dt, b_t, c_t, a, d_skip, h0, dy, dh_final) == "cpu":
        return _plain(mamba_scan_backward, work.mamba_bwd_work(b, l, di, n),
                      plain.mamba_scan_backward_plain, x, dt, b_t, c_t, a,
                      d_skip, h0, dy, dh_final)
    _card_scan("mamba_scan_backward", MAMBA_STATE_SIZES, n, x=x, dt=dt,
               b_t=b_t, c_t=c_t, a=a, d_skip=d_skip, h0=h0, dy=dy,
               dh_final=dh_final)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.zeros_like(b_t), torch.zeros_like(c_t)
    da, dd, dh0 = (torch.zeros_like(a), torch.zeros_like(d_skip),
                   torch.empty_like(h0))
    if b * di == 0:
        return dx, ddt, db, dc, da, dd, dh0
    if x.is_meta:
        tile, width = work.MAMBA_BWD_TILE, work.MAMBA_BWD_WIDTH
    else:
        layout = _build.launcher("mamba_scan_bwd_layout")
        tile, width = layout(0), layout(1)
    blocks = -(-di // width)
    f32 = {"dtype": torch.float32, "device": x.device}
    chk = torch.empty(b * blocks * width * n * (-(-l // tile)), **f32)
    part_bc = torch.empty(blocks * b * l * 2 * n, **f32)
    part_a = torch.empty((b, di, n), **f32)
    part_d = torch.empty((b, di), **f32)
    if _stand_in(mamba_scan_backward, x,
                 lambda: work.mamba_bwd_work(b, l, di, n)):
        return dx, ddt, db, dc, da, dd, dh0
    _launch("mamba_scan_bwd", *(t.data_ptr() for t in (
        x, dt, b_t, c_t, a, d_skip, h0, dy, dh_final, dx, ddt, db, dc, da,
        dd, dh0, chk, part_bc, part_a, part_d)), b, l, di, n, _stream(x))
    _count(mamba_scan_backward)
    return dx, ddt, db, dc, da, dd, dh0


class Rwkv6Scan(torch.autograd.Function):
    """K7 with its gradient: the forward runs ``rwkv6_scan`` and saves its
    inputs, the backward runs ``rwkv6_scan_backward`` (a final state the
    loss does not use gets a zero gradient).  On the CPU both are the
    plain versions, on the card both are kernels; a failed build or launch
    raises."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        o, s_out = rwkv6_scan(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return o, s_out

    @staticmethod
    def backward(ctx, do, ds):
        return rwkv6_scan_backward(*ctx.saved_tensors, do.contiguous(),
                                   ds.contiguous())


class MambaScan(torch.autograd.Function):
    """K6 with its gradient: ``mamba_scan`` forward, ``mamba_scan_backward``
    backward, as ``Rwkv6Scan``."""

    @staticmethod
    def forward(ctx, x, dt, b_t, c_t, a, d_skip, h0):
        y, h_out = mamba_scan(x, dt, b_t, c_t, a, d_skip, h0)
        ctx.save_for_backward(x, dt, b_t, c_t, a, d_skip, h0)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        return mamba_scan_backward(*ctx.saved_tensors, dy.contiguous(),
                                   dh.contiguous())


def rwkv6_scan_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_scan``, differentiable in all six inputs through K7's
    backward (``Rwkv6Scan``): the train path's recurrence."""
    return Rwkv6Scan.apply(r, k, v, w, u, state)


def mamba_scan_train(x: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor,
                     c_t: torch.Tensor, a: torch.Tensor,
                     d_skip: torch.Tensor, h0: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mamba_scan``, differentiable in all seven inputs through K6's
    backward (``MambaScan``): the train path's selective scan."""
    return MambaScan.apply(x, dt, b_t, c_t, a, d_skip, h0)


KERNELS = (minmax_relax, ell_superstep, column_fingerprints, panel_update,
           panel_update_batched, panel_update_mapped, flash_attention,
           flash_attention_backward, mamba_scan, rwkv6_scan,
           mamba_scan_backward, rwkv6_scan_backward)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()
