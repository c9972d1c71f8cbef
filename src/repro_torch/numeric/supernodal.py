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
  ``ZeroPivotError`` — column, panel, level — as the reference.
* **Level schedule** — panels within a level are independent; with
  ``segment_batch`` a level's trailing updates are one launch.

Entries outside the symbolic prediction stay exactly zero except at a
panel's explicit padding, which is bounded by ``pattern_tol`` and zeroed —
anything larger raises (the ``validate_symbolic`` contract).
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
from repro_torch.numeric.storage import PanelStore
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import (
    ZeroPivotError, check_pivots, lu_inplace, pivot_tolerance,
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


def _panel_finish(store: PanelStore, schedule: PanelSchedule, j: int) -> None:
    """Phase B of panel j: diagonal-block factor + below-panel solve."""
    block = store.blocks[j]
    diag = store.diag_block(j)
    lu_inplace(diag)
    below = int(store.diag[j]) + diag.shape[0]
    if block.shape[0] > below:
        block[below:] = _solve_upper_right(diag, block[below:])


def _trailing_update(store: PanelStore, upd: UpdateMaps, lo: int, hi: int,
                     u: torch.Tensor, backend: str, u_shift: int = 0) -> None:
    """``acc -= L @ U`` in place for the slices of tile records [lo, hi):
    the mapped panel update (K3/K4), L read in place through ``upd.lmap``,
    in float64, or in float32 on the kernel backend.  On the CPU its plain
    version, slice by slice."""
    kops.panel_update_mapped(store.flat, u, upd.lmap, upd.tiles[lo:hi],
                             u_shift=u_shift, f32=backend == "kernel")


def _factor_panel(store: PanelStore, schedule: PanelSchedule, j: int,
                  backend: str, maps: Optional[DevicePanelMaps],
                  upd: UpdateMaps):
    """Factor panel j in place on its packed block (per-panel dispatch: a
    one-slice update).  Returns (#ancestor updates, trailing flops,
    dropped)."""
    b, dropped, flops = _panel_prepare(store, schedule, j, maps)
    if b is not None:
        lo, hi = (int(x) for x in upd.panel_tiles[j])
        _trailing_update(store, upd, lo, hi, b.reshape(-1), backend,
                         u_shift=int(upd.u_off[j]))
    _panel_finish(store, schedule, j)
    return len(schedule.ancestors[j]), flops, dropped


def _factor_segment_batched(store: PanelStore, schedule: PanelSchedule,
                            li: int, seg, backend: str,
                            maps: List[Optional[DevicePanelMaps]],
                            upd: UpdateMaps):
    """Factor level ``li``'s panels ``seg`` with ONE trailing-update launch
    (DESIGN.md §13).

    Three phases: phase A for every panel, then the level's trailing
    updates — its solved U rows concatenated in level order, every slice
    updated in place by one mapped K3/K4 launch — then every diagonal
    factor in segment order.  Panels within a level only read
    strictly-earlier levels and write their own block, and each output's
    operation sequence is the per-panel one, so segment batching gives the
    per-panel factors bitwise.

    Returns per-panel ``(j, n_updates, flops, dropped)`` tuples.
    """
    out = []
    bs = []
    for j in seg:
        j = int(j)
        b, dropped, flops = _panel_prepare(store, schedule, j, maps[j])
        out.append((j, len(schedule.ancestors[j]), flops, dropped))
        if b is not None:
            bs.append(b.reshape(-1))
    if bs:
        _trailing_update(store, upd, int(upd.level_tiles[li]),
                         int(upd.level_tiles[li + 1]), torch.cat(bs),
                         backend)
    if _ot.ENABLED and upd.batched[li, 0]:
        # the reference's stacked same-shape groups of this level (static
        # per plan, tallied in ``UpdateMaps.batched``)
        calls, panels, flops, nbytes = (int(x) for x in upd.batched[li])
        reg = _om.registry()
        reg.count("gemm.batched.calls", calls)
        reg.count("gemm.batched.panels", panels)
        reg.count("gemm.batched.flops", flops)
        reg.count("gemm.batched.bytes", nbytes)
    for j in seg:
        _panel_finish(store, schedule, int(j))
    return out


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
                    segment_batch: bool = True) -> NumericResult:
    """Scatter CSR-aligned ``values`` into ``store`` and run the
    level-scheduled panel sweep on the store's device.

    ``maps`` are the per-panel device gather maps (``schedule.device_maps``),
    ``update_maps`` the device tables of the trailing updates
    (``schedule.UpdateMaps``) and ``csr_maps`` the CSR scatter —
    ``LUPlan.factorize`` passes all three from its analysis; when omitted
    they are derived here.  ``segment_batch`` (default on) runs a level's
    trailing updates as one launch instead of one per panel.
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
    for li, level in enumerate(schedule.levels):
        with _ot.span("factor_level"), _ot.span("factor_segment"):
            if segment_batch and len(level) > 1:
                panel_stats = _factor_segment_batched(
                    store, schedule, li, level, backend, maps, update_maps)
            else:
                panel_stats = [(int(j),) + _factor_panel(
                    store, schedule, int(j), backend, maps[j], update_maps)
                    for j in level]
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
            cols = np.concatenate([np.arange(*schedule.supernodes[j])
                                   for j in level])
            pivs = torch.cat([store.diag_block(j).diagonal() for j in level])
            try:
                check_pivots(cols, pivs, piv_tol)
            except ZeroPivotError as e:
                raise e.with_context(panel=int(store.sup_of_col[e.k]),
                                     level=li)
    if obs_on:
        reg = _om.registry()
        reg.count("gemm.flops", gemm_flops)
        reg.count("gemm.bytes", gemm_bytes)
        reg.count("gemm.seconds", time.perf_counter() - sweep_t0)

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
                         outside_max=outside_max)
