"""Supernodal left-looking numeric LU on packed device storage
(DESIGN.md §4, storage layout §9).

``CSR`` values plus the analysis (schedule, packed store, gather maps) in,
unit-lower L and upper U out, factorized panel-by-panel in the O(nnz(L+U))
packed blocks of ``storage.PanelStore`` on the store's device:

* **Panel gather** — ancestor U rows and L strips are gathered into dense
  operands through device row maps (absent rows are structural zeros).
* **Left-looking updates** — ancestors K of J are consumed in ascending
  order: solve ``U(K, J) = L(K, K)^{-1} X(K, J)``, scatter the rank-|K|
  update into the rows of later ancestors, and defer the whole trailing
  update to one accumulated product ``X(s:, J) -= L(s:, anc) @ U(anc,
  J)``: the mapped panel update (K3/K4), in place in the store with L read
  from the ancestors' blocks through a static map, in float64 on the
  default ``"numpy"`` backend (named after the reference's host BLAS
  backend), in float32 on the ``"kernel"`` backend.
* **Panel factor** — dense no-pivot LU of the diagonal block, then one
  triangular solve for the below-panel L rows.  Pivots are checked once per
  dependency level (one host sync) and a failure raises the same
  ``ZeroPivotError`` — column, panel, level — as the reference.  With
  ``perturb`` a tiny pivot is replaced by the signed threshold on the
  device before its division (``sparse.numeric.PerturbState``), so the
  level's check sees the bumped diagonal; the count is read once, after
  the sweep.
* **Level schedule** — panels within a level are independent; with
  ``segment_batch`` a level's trailing updates are one launch.  A
  ``PanelPlacement`` splits each level into per-device segments that order
  its phases A and B and its pivot check (``factor_segment`` spans, one
  track per device); the level's update stays one launch, so placement
  changes no float operation.

Entries outside the symbolic prediction stay exactly zero except at a
panel's explicit padding, which is bounded by ``pattern_tol`` and zeroed —
anything larger raises (the ``validate_symbolic`` contract).

``factor_batch_on_store`` is the same sweep over B value sets of one plan
(the batched tier) in a ``storage.BatchedPanelStore``: gathers, scatters,
the diagonal LU's column loop and the trailing updates (one mapped K3/K4
launch per level for all B systems) run over the system axis; the
triangular solves and the small products of phase A and phase B stay one
call per system, on buffers at the sequential path's alignment, because a
batched cuBLAS call need not be bitwise its per-matrix form.  So every
system's factors are bitwise ``factor_on_store`` on that system alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.numeric.schedule import (
    DevicePanelMaps, PanelSchedule, UpdateMaps, build_gather_maps,
    build_update_maps, device_maps,
)
from repro_torch.numeric.storage import (
    BatchedPanelStore, PanelStore, batch_buffer, batch_zeros,
)
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import (
    PerturbState, ZeroPivotError, check_pivots, check_pivots_batched,
    lu_inplace, lu_inplace_batched, perturb_threshold, pivot_tolerance,
)

_BACKENDS = ("numpy", "kernel")


@dataclasses.dataclass
class NumericResult:
    """Factors + counters of one supernodal factorization.

    The factors live in the packed device store; ``l``/``u`` are dense host
    reconstructions for parity tests and small n — do not touch them at
    large n.
    """

    n: int
    store: PanelStore
    schedule: PanelSchedule
    backend: str
    elapsed_s: float
    n_updates: int               # ancestor panel updates consumed
    gemm_flops: int              # flops of the accumulated trailing GEMMs
    outside_max: float           # largest |value| found outside the pattern
    perturbed_pivots: int = 0    # tiny pivots bumped by the robust tier
    _dense_lu: Optional[Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def n_supernodes(self) -> int:
        return self.schedule.n_panels

    @property
    def n_levels(self) -> int:
        return self.schedule.n_levels

    @property
    def store_entries(self) -> int:
        return self.store.total_entries

    def _dense(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._dense_lu is None:
            self._dense_lu = self.store.dense_lu()
        return self._dense_lu

    @property
    def l(self) -> np.ndarray:
        """Dense unit-lower L (host) — test/oracle reconstruction helper."""
        return self._dense()[0]

    @property
    def u(self) -> np.ndarray:
        """Dense upper U (host) — test/oracle reconstruction helper."""
        return self._dense()[1]


def _solve_unit_lower(block: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X with (I + strict_lower(block)) @ X = rhs (block stores L\\U packed)."""
    return torch.linalg.solve_triangular(block, rhs, upper=False,
                                         unitriangular=True)


def _solve_upper_right(block: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X with X @ triu(block) = rhs (below-panel L rows)."""
    if block.shape[0] == 1:
        return rhs / block[0, 0]
    return torch.linalg.solve_triangular(block, rhs, upper=True, left=False)


def _panel_prepare(store: PanelStore, schedule: PanelSchedule, j: int,
                   maps: Optional[DevicePanelMaps]):
    """Phase A of panel j: per-ancestor solves + U-row scatter.

    Runs the ascending per-ancestor unit-lower solves and rank updates on
    the gathered target rows and writes the solved U(anc, J) rows back into
    the packed block (rows above its diagonal block).  Reads only
    strictly-earlier-level blocks, so phase A of every panel in a level can
    run before any same-level update/finish.

    Returns (b, dropped, flops): the solved (K, w) U rows, the operand of
    the trailing update, the largest |value| the solves produced on a row
    absent from the panel's structure (0-d device tensor, or None when
    every row is present) and the trailing update's flop count.
    ``(None, None, 0)`` when the panel has no ancestors.
    """
    s, e = schedule.supernodes[j]
    w = int(e - s)
    anc = schedule.ancestors[j]
    if not len(anc):
        return None, None, 0
    offs = maps.offs
    b = store.gather_rows_mapped(j, maps.target)          # (K, w)
    for idx, k in enumerate(anc):
        r0, r1 = int(offs[idx]), int(offs[idx + 1])
        strip = store.gather_rows_mapped(int(k), maps.strips[idx])
        if r1 - r0 > 1:           # a 1-row unit-lower solve is the identity
            b[r0:r1] = _solve_unit_lower(strip[:r1 - r0], b[r0:r1])
        if r1 < maps.n_rows:
            b[r1:] -= strip[r1 - r0:] @ b[r0:r1]
    block = store.blocks[j]
    tgt = maps.target
    block[tgt.sel] = b if tgt.pos is None else b[tgt.pos]
    dropped = b[maps.miss].abs().max() if maps.miss is not None else None
    rows = block.shape[0] - int(store.diag[j])
    return b, dropped, 2 * rows * maps.n_rows * w


def _panel_finish(store: PanelStore, schedule: PanelSchedule, j: int,
                  perturb: Optional[PerturbState] = None) -> None:
    """Phase B of panel j: diagonal-block factor (tiny pivots bumped with
    ``perturb``) + below-panel solve."""
    block = store.blocks[j]
    diag = store.diag_block(j)
    lu_inplace(diag, perturb=perturb)
    below = int(store.diag[j]) + diag.shape[0]
    if block.shape[0] > below:
        block[below:] = _solve_upper_right(diag, block[below:])


def _trailing_update(store, upd: UpdateMaps, lo: int, hi: int,
                     u: torch.Tensor, backend: str, u_shift: int = 0) -> None:
    """``acc -= L @ U`` in place for the slices of tile records [lo, hi):
    the mapped panel update (K3/K4), L read in place through ``upd.lmap``,
    in float64, or in float32 on the kernel backend.  On the CPU its plain
    version, slice by slice.  For a ``BatchedPanelStore`` ``u`` is (B, K)
    with each system's row a contiguous run (``batch_buffer``) and one
    launch updates every system (the system stride)."""
    if isinstance(store, BatchedPanelStore):
        kops.panel_update_mapped(batch_buffer(store.flat), batch_buffer(u),
                                 upd.lmap, upd.tiles[lo:hi], u_shift=u_shift,
                                 f32=backend == "kernel",
                                 systems=store.batch,
                                 flat_stride=store.flat.stride(0),
                                 u_stride=u.stride(0))
        return
    kops.panel_update_mapped(store.flat, u, upd.lmap, upd.tiles[lo:hi],
                             u_shift=u_shift, f32=backend == "kernel")


def _factor_panel(store: PanelStore, schedule: PanelSchedule, j: int,
                  backend: str, maps: Optional[DevicePanelMaps],
                  upd: UpdateMaps, perturb: Optional[PerturbState] = None):
    """Factor panel j in place on its packed block (per-panel dispatch: a
    one-slice update).  Returns (#ancestor updates, trailing flops,
    dropped)."""
    b, dropped, flops = _panel_prepare(store, schedule, j, maps)
    if b is not None:
        lo, hi = (int(x) for x in upd.panel_tiles[j])
        _trailing_update(store, upd, lo, hi, b.reshape(-1), backend,
                         u_shift=int(upd.u_off[j]))
    _panel_finish(store, schedule, j, perturb)
    return len(schedule.ancestors[j]), flops, dropped


class _SegmentClock:
    """Per-segment times of a placed sweep, taken under tracing only: CUDA
    events on the store's device, read once after the sweep (so the sweep
    gains no host sync), or the host clock on the CPU.  Each level records
    ``(device, start, end)`` stamps; a segment's time sums its stamps."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.levels: List[List[tuple]] = []

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def observe(self) -> None:
        """``factor.level_imbalance_measured``: max / mean segment time of
        every level with more than one busy segment."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        reg = _om.registry()
        for stamps in self.levels:
            times = {}
            for d, t0, t1 in stamps:
                dt = t0.elapsed_time(t1) / 1e3 if self.cuda else t1 - t0
                times[d] = times.get(d, 0.0) + dt
            if len(times) > 1:
                mean_t = sum(times.values()) / len(times)
                if mean_t > 0:
                    reg.observe("factor.level_imbalance_measured",
                                max(times.values()) / mean_t)


def _level_segments(placement, level) -> tuple:
    """``(device, panels)`` of one level: its non-empty placement segments
    in device order, or ``((None, level),)`` without a placement."""
    if placement is None or placement.n_devices <= 1:
        return ((None, level),)
    return tuple((d, seg) for d, seg in enumerate(placement.segments(level))
                 if len(seg))


def _in_segments(segments, clock: Optional[_SegmentClock], work) -> list:
    """``work(seg)`` for every segment in order, each under a
    ``factor_segment`` span on its device's track, stamped on ``clock``;
    returns the concatenated per-segment results."""
    out = []
    for d, seg in segments:
        track = f"device {d}" if d is not None else None
        with _ot.span("factor_segment", track=track):
            t0 = clock.stamp() if clock is not None else None
            out.extend(work(seg))
            if clock is not None:
                clock.levels[-1].append((d, t0, clock.stamp()))
    return out


def _factor_level_segments(store: PanelStore, schedule: PanelSchedule,
                           li: int, segments, backend: str,
                           maps: List[Optional[DevicePanelMaps]],
                           upd: UpdateMaps,
                           perturb: Optional[PerturbState] = None,
                           clock: Optional[_SegmentClock] = None):
    """Factor level ``li`` with ONE trailing-update launch (DESIGN.md §13).

    Three phases: phase A for every panel, segment by segment; then the
    level's trailing updates — its solved U rows concatenated in level
    order, every slice updated in place by one mapped K3/K4 launch; then
    every diagonal factor, segment by segment.  Panels within a level only
    read strictly-earlier levels and write their own block, and each
    output's operation sequence is the per-panel one, so neither segment
    batching nor the segment order changes a bit of the factors.

    Returns per-panel ``(j, n_updates, flops, dropped)`` tuples.
    """
    bs = {}

    def prepare(seg):
        out = []
        for j in seg:
            j = int(j)
            b, dropped, flops = _panel_prepare(store, schedule, j, maps[j])
            out.append((j, len(schedule.ancestors[j]), flops, dropped))
            if b is not None:
                bs[j] = b.reshape(-1)
        return out

    def finish(seg):
        for j in seg:
            _panel_finish(store, schedule, int(j), perturb)
        return ()

    out = _in_segments(segments, clock, prepare)
    if bs:
        _trailing_update(store, upd, int(upd.level_tiles[li]),
                         int(upd.level_tiles[li + 1]),
                         torch.cat([bs[int(j)] for j in schedule.levels[li]
                                    if int(j) in bs]), backend)
    if _ot.ENABLED:
        _count_batched_gemms(upd, li, 1)
    _in_segments(segments, clock, finish)
    return out


def _count_batched_gemms(upd: UpdateMaps, li: int, systems: int) -> None:
    """``gemm.batched.*`` of level ``li`` (tracing only): the reference's
    stacked same-shape groups of more than one panel, static per plan
    (``UpdateMaps.batched``), flops and bytes times ``systems``."""
    calls, panels, flops, nbytes = (int(x) for x in upd.batched[li])
    if not calls:
        return
    reg = _om.registry()
    reg.count("gemm.batched.calls", calls)
    reg.count("gemm.batched.panels", panels)
    reg.count("gemm.batched.flops", flops * systems)
    reg.count("gemm.batched.bytes", nbytes * systems)


def factor_on_store(a: Optional[CSRMatrix], values, store: PanelStore,
                    schedule: PanelSchedule, *,
                    backend: str = "numpy",
                    piv_tol: Optional[float] = None,
                    check_pattern: bool = True,
                    pattern_tol: Optional[float] = None,
                    maps: Optional[List[Optional[DevicePanelMaps]]] = None,
                    update_maps: Optional[UpdateMaps] = None,
                    csr_maps=None,
                    store_is_zeroed: bool = False,
                    segment_batch: bool = True,
                    perturb: bool = False,
                    perturb_eps: Optional[float] = None,
                    placement=None) -> NumericResult:
    """Scatter CSR-aligned ``values`` into ``store`` and run the
    level-scheduled panel sweep on the store's device.

    ``maps`` are the per-panel device gather maps (``schedule.device_maps``),
    ``update_maps`` the device tables of the trailing updates
    (``schedule.UpdateMaps``) and ``csr_maps`` the CSR scatter —
    ``LUPlan.factorize`` passes all three from its analysis; when omitted
    they are derived here.  ``segment_batch`` (default on) runs a level's
    trailing updates as one launch instead of one per panel.

    ``perturb`` enables tiny-pivot perturbation: pivots with |piv| <=
    ``perturb_eps``·max|A| (default sqrt(machine eps)) are replaced by that
    signed threshold instead of raising, counted in
    ``NumericResult.perturbed_pivots``.

    ``placement`` (a ``schedule.PanelPlacement``) splits every level into
    its non-empty per-device segments, in device order: they order the
    level's phases A and B and its pivot check, each under a
    ``factor_segment`` span on track ``device d``; the level's trailing
    updates stay one launch.  On one card a segment is a scheduling order
    on the store's stream (the reference's behaviour whenever it sees fewer
    devices than the placement has), so the factors are bitwise the
    unplaced sweep's at every device count.  With tracing on, each level's
    ``factor.level_imbalance_measured`` (max / mean segment time) is
    recorded from CUDA events read once after the sweep.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {_BACKENDS}")
    n = store.n
    if pattern_tol is None:
        # float32 kernel updates leave f32-roundoff garbage at the explicit
        # zeros of relaxed panels; the float64 path stays at f64 roundoff
        pattern_tol = 1e-4 if backend == "kernel" else 1e-8
    t0 = time.perf_counter()

    values = torch.as_tensor(values, dtype=torch.float64, device=store.device)
    if values.dim() != 1:
        raise ValueError(f"values must be CSR-aligned (nnz,), got "
                         f"{tuple(values.shape)}")
    with _ot.span("scatter_values"):
        if csr_maps is None:
            if a is None:
                raise ValueError(
                    "CSR-aligned values need the matrix `a` or precomputed "
                    "`csr_maps` to locate their slots")
            csr_maps = store.csr_maps(a)
        dropped = [store.set_csr_mapped(values, csr_maps,
                                        zero=not store_is_zeroed)]

    scale = float(values.abs().max()) if values.numel() else 0.0
    if piv_tol is None:
        piv_tol = pivot_tolerance(scale)
    pstate = (PerturbState(perturb_threshold(scale, perturb_eps),
                           store.device) if perturb else None)
    if maps is None or update_maps is None:
        host_maps = build_gather_maps(store, schedule)
        if maps is None:
            maps = device_maps(host_maps, store.device)
        if update_maps is None:
            update_maps = build_update_maps(store, schedule,
                                            host_maps).to(store.device)

    n_updates = 0
    gemm_flops = 0
    # obs accounting (only touched when tracing is enabled): analytic GEMM
    # traffic accumulates from shapes the sweep already knows
    obs_on = _ot.ENABLED
    gemm_bytes = 0
    sweep_t0 = time.perf_counter() if obs_on else 0.0
    clock = (_SegmentClock(store.device)
             if obs_on and placement is not None and placement.n_devices > 1
             else None)
    for li, level in enumerate(schedule.levels):
        segments = _level_segments(placement, level)
        if clock is not None:
            clock.levels.append([])
        with _ot.span("factor_level"):
            if segment_batch and len(level) > 1:
                panel_stats = _factor_level_segments(
                    store, schedule, li, segments, backend, maps,
                    update_maps, pstate, clock)
            else:
                panel_stats = _in_segments(segments, clock, lambda seg: [
                    (int(j),) + _factor_panel(
                        store, schedule, int(j), backend, maps[j],
                        update_maps, pstate)
                    for j in seg])
            for j, upd, flops, drop in panel_stats:
                n_updates += upd
                gemm_flops += flops
                if drop is not None:
                    dropped.append(drop)
                if obs_on and flops:
                    s_, e_ = schedule.supernodes[j]
                    w_ = int(e_ - s_)
                    nb = len(store.rows[j]) - int(store.diag[j])
                    k_ = flops // (2 * nb * w_)
                    gemm_bytes += 8 * (nb * k_ + k_ * w_ + 2 * nb * w_)
            # every pivot this level divided by, in execution order
            order = [j for _, seg in segments for j in seg]
            cols = np.concatenate([np.arange(*schedule.supernodes[j])
                                   for j in order])
            pivs = torch.cat([store.diag_block(j).diagonal() for j in order])
            try:
                check_pivots(cols, pivs, piv_tol)
            except ZeroPivotError as e:
                raise e.with_context(panel=int(store.sup_of_col[e.k]),
                                     level=li)
    if clock is not None:
        clock.observe()
    perturbed = pstate.total() if pstate is not None else 0
    if obs_on:
        reg = _om.registry()
        reg.count("gemm.flops", gemm_flops)
        reg.count("gemm.bytes", gemm_bytes)
        reg.count("gemm.seconds", time.perf_counter() - sweep_t0)
        if perturbed:
            reg.count("robust.perturbed_pivots", perturbed)

    dropped.append(store.padding_max())
    outside_max = float(torch.stack(dropped).max())
    if check_pattern and outside_max > pattern_tol * scale:
        raise ValueError(
            f"numeric factorization escaped the symbolic prediction: "
            f"|{outside_max:.3e}| outside the pattern (tol "
            f"{pattern_tol * scale:.3e}) — symbolic under-prediction")
    store.zero_padding()

    return NumericResult(n=n, store=store, schedule=schedule, backend=backend,
                         elapsed_s=time.perf_counter() - t0,
                         n_updates=n_updates, gemm_flops=gemm_flops,
                         outside_max=outside_max, perturbed_pivots=perturbed)


@dataclasses.dataclass
class BatchedNumericResult:
    """Factors of B same-pattern value sets in one ``BatchedPanelStore``.

    ``n_updates``/``gemm_flops`` are *per system* — the sweep structure is
    value-independent, so every system does identical work.
    ``outside_max`` is the (B,) per-system escape check.  ``system(i)``
    wraps system i's zero-copy store view as a plain ``NumericResult`` so
    per-system consumers (solve, dense reconstruction) run unchanged.
    """

    n: int
    batch: int
    store: BatchedPanelStore
    schedule: PanelSchedule
    backend: str
    elapsed_s: float
    n_updates: int               # ancestor panel updates, per system
    gemm_flops: int              # trailing-update flops, per system
    outside_max: np.ndarray      # (B,) largest |value| outside the pattern
    perturbed_pivots: Optional[np.ndarray] = None   # (B,) per-system counts

    @property
    def n_supernodes(self) -> int:
        return self.schedule.n_panels

    @property
    def n_levels(self) -> int:
        return self.schedule.n_levels

    def system(self, i: int) -> NumericResult:
        return NumericResult(n=self.n, store=self.store.system(i),
                             schedule=self.schedule, backend=self.backend,
                             elapsed_s=0.0, n_updates=self.n_updates,
                             gemm_flops=self.gemm_flops,
                             outside_max=float(self.outside_max[i]),
                             perturbed_pivots=(
                                 int(self.perturbed_pivots[i])
                                 if self.perturbed_pivots is not None
                                 else 0))


def _panel_prepare_batched(bstore: BatchedPanelStore,
                           schedule: PanelSchedule, j: int,
                           maps: Optional[DevicePanelMaps]):
    """``_panel_prepare`` over the system axis: one gather and one U-row
    scatter serve all B systems; each ancestor's unit-lower solve and rank
    update are one call per system on that system's slices (buffers at the
    sequential path's alignment, ``storage.batch_zeros``), so every system
    sees the sequential calls.  Returns (b (B, K, w), dropped (B,) or None,
    flops per system)."""
    s, e = schedule.supernodes[j]
    w = int(e - s)
    anc = schedule.ancestors[j]
    if not len(anc):
        return None, None, 0
    offs = maps.offs
    b = bstore.gather_rows_mapped(j, maps.target)         # (B, K, w)
    for idx, k in enumerate(anc):
        r0, r1 = int(offs[idx]), int(offs[idx + 1])
        strip = bstore.gather_rows_mapped(int(k), maps.strips[idx])
        for i in range(bstore.batch):
            if r1 - r0 > 1:       # a 1-row unit-lower solve is the identity
                b[i, r0:r1] = _solve_unit_lower(strip[i, :r1 - r0],
                                                b[i, r0:r1])
            if r1 < maps.n_rows:
                b[i, r1:] -= strip[i, r1 - r0:] @ b[i, r0:r1]
    block = bstore.blocks[j]
    tgt = maps.target
    block[:, tgt.sel] = b if tgt.pos is None else b[:, tgt.pos]
    dropped = (b[:, maps.miss].abs().amax(dim=(1, 2))
               if maps.miss is not None else None)
    rows = block.shape[1] - int(bstore.diag[j])
    return b, dropped, 2 * rows * maps.n_rows * w


def _panel_finish_batched(bstore: BatchedPanelStore,
                          schedule: PanelSchedule, j: int,
                          perturb: Optional[PerturbState] = None) -> None:
    """``_panel_finish`` over the system axis: the elementwise batched
    diagonal LU (each system's tiny pivots bumped against its own
    threshold with ``perturb``), then the below-panel solve — one division
    for a 1-wide panel, one triangular solve per system otherwise."""
    block = bstore.blocks[j]
    diag = bstore.diag_block(j)
    lu_inplace_batched(diag, perturb=perturb)
    below = int(bstore.diag[j]) + diag.shape[1]
    if block.shape[1] > below:
        if diag.shape[1] == 1:
            block[:, below:] = block[:, below:] / diag[:, :1, :1]
        else:
            for i in range(bstore.batch):
                block[i, below:] = _solve_upper_right(diag[i],
                                                      block[i, below:])


def _factor_panel_batched(bstore: BatchedPanelStore, schedule, j: int,
                          backend: str, maps, upd: UpdateMaps,
                          perturb: Optional[PerturbState] = None):
    """Phase A, the panel's trailing update for all B systems (one mapped
    K3/K4 launch) and phase B of panel j (per-panel dispatch).  Returns
    (#ancestor updates, trailing flops, dropped)."""
    b, dropped, flops = _panel_prepare_batched(bstore, schedule, j, maps)
    if b is not None:
        lo, hi = (int(x) for x in upd.panel_tiles[j])
        _trailing_update(bstore, upd, lo, hi, b.reshape(bstore.batch, -1),
                         backend, u_shift=int(upd.u_off[j]))
    _panel_finish_batched(bstore, schedule, j, perturb)
    return len(schedule.ancestors[j]), flops, dropped


def _factor_level_batched(bstore: BatchedPanelStore, schedule, li: int,
                          level, backend: str, maps, upd: UpdateMaps,
                          perturb: Optional[PerturbState] = None):
    """Level ``li`` for all B systems with ONE trailing-update launch: phase
    A for every panel, the level's solved U rows stacked as (B, K_level)
    in level order, one mapped K3/K4 launch over the systems, then every
    phase B.  Returns per-panel ``(j, n_updates, flops, dropped)``."""
    out, bs = [], []
    for j in level:
        j = int(j)
        b, dropped, flops = _panel_prepare_batched(bstore, schedule, j,
                                                   maps[j])
        out.append((j, len(schedule.ancestors[j]), flops, dropped))
        if b is not None:
            bs.append(b.reshape(bstore.batch, -1))
    if bs:
        # each system's U rows at a fresh buffer's alignment, as the
        # sequential level's concatenation (the plain version's products)
        u = batch_zeros(bstore.batch, (sum(b.shape[1] for b in bs),),
                        bstore.device)
        u.copy_(torch.cat(bs, dim=1))
        _trailing_update(bstore, upd, int(upd.level_tiles[li]),
                         int(upd.level_tiles[li + 1]), u, backend)
    for j in level:
        _panel_finish_batched(bstore, schedule, int(j), perturb)
    return out


def factor_batch_on_store(a: Optional[CSRMatrix], values_batch,
                          bstore: BatchedPanelStore,
                          schedule: PanelSchedule, *,
                          backend: str = "numpy",
                          piv_tol: Optional[float] = None,
                          check_pattern: bool = True,
                          pattern_tol: Optional[float] = None,
                          maps: Optional[List[Optional[DevicePanelMaps]]] = None,
                          update_maps: Optional[UpdateMaps] = None,
                          csr_maps=None,
                          store_is_zeroed: bool = False,
                          segment_batch: bool = True,
                          perturb: bool = False,
                          perturb_eps: Optional[float] = None
                          ) -> BatchedNumericResult:
    """``factor_on_store`` over B same-pattern value sets: scatter the
    (B, nnz) CSR-aligned stack into ``bstore`` and run ONE level-scheduled
    sweep whose every per-panel step carries the leading system axis.

    System i's factors are **bitwise** ``factor_on_store(a,
    values_batch[i], ...)`` on a store of its own: the scatter, gathers,
    diagonal LU and the mapped K3/K4 run over the systems (each system of
    a multi-system launch is bitwise the one-system launch), the solves and
    phase A's products are the sequential calls, one per system.  Pivot
    tolerance (``piv_tol=None``: eps at each system's own value scale), the
    pattern-escape check, ``ZeroPivotError`` (naming the system) and
    ``perturb`` (``perturb_eps`` times each system's own value scale, and
    the count) are per system.  The trailing updates are one launch per level for all systems
    with ``segment_batch`` (one per panel without)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {_BACKENDS}")
    n = bstore.n
    bsz = bstore.batch
    if pattern_tol is None:
        pattern_tol = 1e-4 if backend == "kernel" else 1e-8
    t0 = time.perf_counter()

    values_batch = torch.as_tensor(values_batch, dtype=torch.float64,
                                   device=bstore.device)
    template = bstore.template
    if csr_maps is None:
        if a is None:
            raise ValueError(
                "batched CSR values need the matrix `a` or precomputed "
                "`csr_maps` to locate their slots")
        csr_maps = template.csr_maps(a)
    if tuple(values_batch.shape) != (bsz, csr_maps.nnz):
        raise ValueError(
            f"values_batch must be ({bsz}, {csr_maps.nnz}) CSR-aligned, "
            f"got {tuple(values_batch.shape)}")
    with _ot.span("scatter_values"):
        dropped = [bstore.set_csr_mapped(values_batch, csr_maps,
                                         zero=not store_is_zeroed)]

    scale = (values_batch.abs().amax(dim=1).cpu().numpy() if csr_maps.nnz
             else np.zeros(bsz, dtype=np.float64))
    if piv_tol is None:
        # pivot_tolerance at each system's own value scale
        piv_tol_sys = np.finfo(np.float64).eps * np.maximum(scale, 0.0)
    else:
        piv_tol_sys = np.full(bsz, float(piv_tol))
    eps = np.float64(perturb_threshold(1.0, perturb_eps))
    pstate = (PerturbState(eps * np.maximum(scale, 0.0), bstore.device)
              if perturb else None)
    if maps is None or update_maps is None:
        host_maps = build_gather_maps(template, schedule)
        if maps is None:
            maps = device_maps(host_maps, bstore.device)
        if update_maps is None:
            update_maps = build_update_maps(template, schedule,
                                            host_maps).to(bstore.device)

    n_updates = 0
    gemm_flops = 0
    obs_on = _ot.ENABLED
    sweep_t0 = time.perf_counter() if obs_on else 0.0
    for li, level in enumerate(schedule.levels):
        with _ot.span("factor_level"), _ot.span("factor_segment"):
            if segment_batch and len(level) > 1:
                panel_stats = _factor_level_batched(
                    bstore, schedule, li, level, backend, maps, update_maps,
                    pstate)
            else:
                panel_stats = [(int(j),) + _factor_panel_batched(
                    bstore, schedule, int(j), backend, maps[j], update_maps,
                    pstate)
                    for j in level]
            if obs_on:
                _count_batched_gemms(update_maps, li, bsz)
            for j, upd, flops, drop in panel_stats:
                n_updates += upd
                gemm_flops += flops
                if drop is not None:
                    dropped.append(drop)
            # every pivot this level divided by, in execution order
            cols = np.concatenate([np.arange(*schedule.supernodes[j])
                                   for j in level])
            pivs = torch.cat([bstore.diag_block(int(j)).diagonal(
                dim1=1, dim2=2) for j in level], dim=1)
            try:
                check_pivots_batched(cols, pivs, piv_tol_sys)
            except ZeroPivotError as e:
                raise e.with_context(panel=int(template.sup_of_col[e.k]),
                                     level=li)
    perturbed = (pstate.count.cpu().numpy() if pstate is not None
                 else None)
    if obs_on:
        reg = _om.registry()
        reg.count("gemm.flops", gemm_flops * bsz)
        reg.count("gemm.seconds", time.perf_counter() - sweep_t0)
        if perturbed is not None and perturbed.sum():
            reg.count("robust.perturbed_pivots", int(perturbed.sum()))

    dropped.append(bstore.padding_max())
    outside_max = torch.stack(dropped).amax(dim=0).cpu().numpy()
    bad = outside_max > pattern_tol * scale
    if check_pattern and bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"numeric factorization escaped the symbolic prediction: "
            f"system {i} has |{outside_max[i]:.3e}| outside the pattern "
            f"(tol {pattern_tol * scale[i]:.3e}) — symbolic "
            f"under-prediction")
    bstore.zero_padding()

    return BatchedNumericResult(n=n, batch=bsz, store=bstore,
                                schedule=schedule, backend=backend,
                                elapsed_s=time.perf_counter() - t0,
                                n_updates=n_updates, gemm_flops=gemm_flops,
                                outside_max=outside_max,
                                perturbed_pivots=perturbed)
