"""Panel-level scheduling for supernodal numeric LU (DESIGN.md §4).

The symbolic step hands over a supernode partition — contiguous ``[start,
end)`` column ranges with identical below-diagonal structure — and the
numeric step must factor those panels in an order that respects column
dependencies.  Panel J depends on panel K < J iff the filled pattern has a
structural nonzero in the U block ``U(K, J)`` (rows of K, columns of J):
exactly then does K's L panel update J.  That is the supernodal elimination
DAG (the condensation of the column etree onto supernodes).

``build_schedule`` derives, from the predicted pattern (dense bool (n, n)
or the sparse ``storage.CSCPattern`` — the sparse form is what the
O(nnz(L+U)) packed path feeds it, nothing here materializes (n, n)):

* ``ancestors[j]`` — the update list of panel j (ascending supernode ids);
  left-looking consumes it in order: solve ``U(K, J)`` against L(K, K),
  scatter into the rows of *later* ancestors, and defer the trailing rows to
  one accumulated GEMM (supernodal.py);
* ``level``/``levels`` — longest-path dependency levels: panels within a
  level share no ancestor relation and can be factored independently (batch
  unit for stacked GEMM dispatch);
* ``partition`` — the ``pack_panels`` bin assignment (LPT or contiguous) the
  scheduler uses to group independent panels within a level; the numeric
  result is invariant to the packing policy (tests assert bitwise equality),
  only the batching/placement changes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import mapped_tiles
from repro_torch.numeric.storage import CSCPattern, RowGather
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.supernodes.balance import PanelPartition, pack_panels


@dataclasses.dataclass
class PanelSchedule:
    """Dependency-levelled execution plan over the supernode partition."""

    supernodes: np.ndarray        # (k, 2) [start, end) column ranges
    ancestors: List[np.ndarray]   # per panel: ascending ids of update panels
    level: np.ndarray             # (k,) dependency level of each panel
    levels: List[np.ndarray]      # panel ids per level, in execution order
    partition: PanelPartition     # pack_panels bins (batching/placement)
    col_counts: np.ndarray        # (n,) below-diagonal column counts of L

    @property
    def n_panels(self) -> int:
        return len(self.supernodes)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def stats(self) -> dict:
        widths = self.supernodes[:, 1] - self.supernodes[:, 0]
        n_updates = sum(len(a) for a in self.ancestors)
        return {
            "n_panels": self.n_panels,
            "n_levels": self.n_levels,
            "mean_level_width": (self.n_panels / max(1, self.n_levels)),
            "max_panel_cols": int(widths.max()) if len(widths) else 0,
            "n_updates": n_updates,
            "balance_ratio": self.partition.balance_ratio,
        }


@dataclasses.dataclass(frozen=True)
class PanelPlacement:
    """Device assignment of panels for a placed factorize/solve.

    Derived from ``pack_panels`` bins computed *per dependency level*: each
    level's panels — exactly the independent work of one sweep step — are
    LPT-packed by predicted L-panel nnz into ``n_devices`` bins, so every
    level's critical path is within one panel weight of optimal.  Within a
    level panels are independent (left-looking panels only read
    strictly-earlier levels), so *any* segment order gives bitwise the same
    factors — placement changes scheduling, never math.

    Plain numpy only — plans stay picklable; the mesh is never stored.
    """

    n_devices: int
    axis: str                      # mesh axis name (launch.mesh.FLAT_AXIS)
    device_of_panel: np.ndarray    # (k,) int64 device id per panel

    def segments(self, members: np.ndarray) -> List[np.ndarray]:
        """Per-device panel lists of one level (ascending ids within each
        segment; devices without work get empty segments)."""
        members = np.asarray(members, dtype=np.int64)
        dev = self.device_of_panel[members]
        return [np.sort(members[dev == d]) for d in range(self.n_devices)]

    def level_loads(self, schedule: "PanelSchedule") -> np.ndarray:
        """(n_levels, n_devices) packed panel weight per device per level —
        the placement-quality surface."""
        from repro_torch.supernodes.balance import supernode_weights

        weights = supernode_weights(schedule.supernodes, schedule.col_counts)
        out = np.zeros((schedule.n_levels, self.n_devices), dtype=np.int64)
        for lv, members in enumerate(schedule.levels):
            np.add.at(out[lv], self.device_of_panel[members],
                      weights[members])
        return out


def build_placement(schedule: PanelSchedule, n_devices: int, *,
                    axis: str = "shards",
                    policy: str = "lpt") -> PanelPlacement:
    """Panel -> device assignment from per-level ``pack_panels`` bins (see
    ``PanelPlacement``).  ``n_devices=1`` puts everything on device 0 — the
    same code path at every count.  With tracing on and more than one
    device, each level's modeled imbalance (max / mean packed weight of its
    busy bins) is observed as ``placement.imbalance_modeled``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    with _ot.span("placement"):
        device_of_panel = np.zeros(schedule.n_panels, dtype=np.int64)
        for members in schedule.levels:
            if not len(members):
                continue
            part = pack_panels(schedule.supernodes[members],
                               schedule.col_counts,
                               min(n_devices, len(members)), policy=policy)
            device_of_panel[members] = part.assignment
        placement = PanelPlacement(n_devices=n_devices, axis=axis,
                                   device_of_panel=device_of_panel)
        if _ot.ENABLED and n_devices > 1:
            loads = placement.level_loads(schedule)
            reg = _om.registry()
            for lv in range(loads.shape[0]):
                busy = loads[lv][loads[lv] > 0]
                if len(busy):
                    reg.observe("placement.imbalance_modeled",
                                float(busy.max()) / float(busy.mean()))
        return placement


@dataclasses.dataclass
class PanelMaps:
    """Value-independent row-index maps of one panel's ancestor updates.

    Everything ``supernodal._factor_panel`` would otherwise re-derive with
    ``searchsorted`` on every factorization: the concatenated ancestor
    diagonal rows, each ancestor's (idx, hit) gather map for its L strip at
    those rows and at the panel's >= s rows, and the scatter map of the
    solved U rows back into the panel block.  Built once per analysis
    (``build_gather_maps``), replayed on every ``LUPlan.factorize`` —
    bitwise-identical math, none of the map reconstruction.
    """

    anc_rows: np.ndarray                 # concatenated ancestor diag rows
    offs: np.ndarray                     # (len(anc)+1,) strip offsets
    strip_maps: List[tuple]              # per ancestor: (idx, hit) at anc_rows[r0:]
    below_maps: List[tuple]              # per ancestor: (idx, hit) at rows >= s
    idx_j: np.ndarray                    # scatter of solved U(anc, J) into block j
    hit_j: np.ndarray

    def to(self, device) -> "DevicePanelMaps":
        """The phase-A maps as device index tensors (``storage.RowGather``);
        the below-row maps go into ``UpdateMaps.lmap`` instead."""
        miss = np.flatnonzero(~self.hit_j)
        return DevicePanelMaps(
            offs=self.offs, n_rows=len(self.anc_rows),
            strips=[RowGather.build(i, h, device) for i, h in self.strip_maps],
            target=RowGather.build(self.idx_j, self.hit_j, device),
            miss=(torch.as_tensor(miss, dtype=torch.int64, device=device)
                  if len(miss) else None))


@dataclasses.dataclass(frozen=True)
class DevicePanelMaps:
    """Device form of ``PanelMaps``' phase-A half, built once per (plan,
    device): the ancestor strip gathers, the gather/scatter of the solved
    U rows in the target block (``target``), and the U rows the target
    block lacks (``miss``, None when every row is present)."""

    offs: np.ndarray
    n_rows: int
    strips: List[RowGather]
    target: RowGather
    miss: Optional[torch.Tensor]


def device_maps(maps: List[Optional[PanelMaps]], device
                ) -> List[Optional[DevicePanelMaps]]:
    return [m.to(device) if m is not None else None for m in maps]


def build_panel_maps(store, schedule: PanelSchedule,
                     j: int) -> Optional[PanelMaps]:
    """Maps for one panel (``None`` when it has no ancestors)."""
    anc = schedule.ancestors[j]
    if not len(anc):
        return None
    widths = schedule.supernodes[anc, 1] - schedule.supernodes[anc, 0]
    offs = np.concatenate([[0], np.cumsum(widths)])
    anc_rows = np.concatenate([np.arange(ks, ke)
                               for ks, ke in schedule.supernodes[anc]])
    below = store.rows[j][int(store.diag[j]):]
    strip_maps = [store.local_rows(int(k), anc_rows[offs[idx]:])
                  for idx, k in enumerate(anc)]
    below_maps = [store.local_rows(int(k), below) for k in anc]
    idx_j, hit_j = store.local_rows(j, anc_rows)
    return PanelMaps(anc_rows=anc_rows, offs=offs, strip_maps=strip_maps,
                     below_maps=below_maps, idx_j=idx_j, hit_j=hit_j)


def build_gather_maps(store, schedule: PanelSchedule) -> List[Optional[PanelMaps]]:
    """Precompute every panel's ancestor gather/scatter maps from the packed
    row structure — the value-independent half of ``supernodal
    ._factor_panel``, built once per analysis and replayed per factorize."""
    return [build_panel_maps(store, schedule, j)
            for j in range(schedule.n_panels)]


@dataclasses.dataclass(frozen=True)
class UpdateMaps:
    """Static tables of the trailing updates of one store structure, for
    the mapped panel update (``kernels.ops.panel_update_mapped``): every
    panel with ancestors is one slice ``acc -= L @ U``, acc its block rows
    from its diagonal down, L read in place from its ancestors' blocks,
    U its solved U rows.

    * ``lmap`` — int32 flat offsets of every slice's (M, K) L entries,
      row-major; column order is the ancestors in schedule order, each
      ancestor's columns in order (the order of the K chain); -1 where the
      ancestor lacks the row (an exact zero);
    * ``tiles`` — the int32 tile records (``ops.mapped_tiles``) of every
      slice, level by level, each level's slices in level order; ``u_off``
      counts from the start of the slice's level's U buffer, the level's
      solved U rows concatenated in that order;
    * ``level_tiles`` — (n_levels + 1,) bounds of each level's records;
    * ``panel_tiles`` — (n_panels, 2) bounds of each panel's records
      ((0, 0) for a panel without ancestors); ``u_off`` — (n_panels,) each
      panel's U offset in its level's buffer;
    * ``batched`` — (n_levels, 4) int64 ``gemm.batched.{calls, panels,
      flops, bytes}`` of each level under segment batching, in the
      reference's meaning: its slices grouped by (m, k, w), one call per
      group of more than one slice, ``2·len·m·k·w`` flops and
      ``8·len·(m·k + k·w + 2·m·w)`` bytes each.

    Offsets, never pointers: a factorization on a fresh store of the same
    structure reuses the tables.  Value-independent, so built once per
    (plan, device) next to the gather maps (``to``)."""

    lmap: np.ndarray
    tiles: np.ndarray
    level_tiles: np.ndarray
    panel_tiles: np.ndarray
    u_off: np.ndarray
    batched: np.ndarray

    def to(self, device) -> "UpdateMaps":
        """The same tables with ``lmap`` and ``tiles`` on ``device``."""
        return dataclasses.replace(
            self, lmap=torch.as_tensor(self.lmap, device=device),
            tiles=torch.as_tensor(self.tiles, device=device))


def build_update_maps(store, schedule: PanelSchedule,
                      maps: List[Optional[PanelMaps]]) -> UpdateMaps:
    """``UpdateMaps`` from the packed store's structure and each panel's
    ``PanelMaps.below_maps``; raises when the store is too large for int32
    offsets."""
    if store.total_entries >= 2 ** 31:
        raise ValueError(f"the mapped panel update addresses the store with "
                         f"int32 offsets; this store has "
                         f"{store.total_entries} entries")
    widths = schedule.supernodes[:, 1] - schedule.supernodes[:, 0]
    lmaps, slices = [], []
    level_slices = [0]
    u_off = np.zeros(schedule.n_panels, dtype=np.int64)
    batched = np.zeros((schedule.n_levels, 4), dtype=np.int64)
    map_off = u_max = 0
    for li, level in enumerate(schedule.levels):
        u_level = 0
        groups: dict = {}
        for j in level:
            pm = maps[j]
            if pm is None:
                continue
            d = int(store.diag[j])
            m, n, k = len(store.rows[j]) - d, int(widths[j]), len(pm.anc_rows)
            cols = []
            for a, (idx, hit) in zip(schedule.ancestors[j], pm.below_maps):
                wa = int(widths[a])
                part = ((store.offsets[a] + idx * wa)[:, None]
                        + np.arange(wa)[None, :])
                part[~hit] = -1
                cols.append(part)
            lmaps.append(np.concatenate(cols, axis=1).ravel())
            slices.append((store.offsets[j] + d * n, map_off, u_level,
                           m, n, k))
            u_off[j] = u_level
            map_off += m * k
            u_level += k * n
            groups[m, k, n] = groups.get((m, k, n), 0) + 1
        for (m, k, n), cnt in groups.items():
            if cnt > 1:
                batched[li] += (1, cnt, 2 * cnt * m * k * n,
                                8 * cnt * (m * k + k * n + 2 * m * n))
        level_slices.append(len(slices))
        u_max = max(u_max, u_level)
    if map_off >= 2 ** 31 or u_max >= 2 ** 31:
        raise ValueError(f"the trailing updates' L map ({map_off} entries) "
                         f"or a level's U rows exceed int32 offsets")
    tiles = mapped_tiles(np.asarray(slices, dtype=np.int64).reshape(-1, 6))
    # each slice's first record is its (m0, n0) = (0, 0) tile
    ptr = np.append(np.flatnonzero((tiles[:, 6] == 0) & (tiles[:, 7] == 0)),
                    len(tiles))
    panel_tiles = np.zeros((schedule.n_panels, 2), dtype=np.int64)
    have = [j for level in schedule.levels for j in level
            if maps[j] is not None]
    panel_tiles[have] = np.column_stack([ptr[:-1], ptr[1:]])
    lmap = (np.concatenate(lmaps).astype(np.int32) if lmaps
            else np.zeros(0, dtype=np.int32))
    return UpdateMaps(lmap=lmap, tiles=tiles,
                      level_tiles=ptr[np.asarray(level_slices)],
                      panel_tiles=panel_tiles, u_off=u_off, batched=batched)


def _validate_supernodes(supernodes: np.ndarray, n: int) -> np.ndarray:
    supernodes = np.asarray(supernodes, dtype=np.int64)
    if supernodes.ndim != 2 or supernodes.shape[1] != 2:
        raise ValueError(f"supernodes must be (k, 2) ranges, got "
                         f"{supernodes.shape}")
    if len(supernodes):
        if supernodes[0, 0] != 0 or supernodes[-1, 1] != n:
            raise ValueError("supernode ranges must cover [0, n)")
        if not (supernodes[1:, 0] == supernodes[:-1, 1]).all():
            raise ValueError("supernode ranges must be contiguous")
        if not (supernodes[:, 1] > supernodes[:, 0]).all():
            raise ValueError("supernode ranges must be non-empty")
    elif n:
        raise ValueError(f"no supernodes for an order-{n} matrix")
    return supernodes


def build_schedule(pattern, supernodes: np.ndarray, *,
                   n_bins: int = 8, policy: str = "lpt") -> PanelSchedule:
    """Schedule from the predicted L+U pattern and supernode ranges.

    ``pattern``: dense (n, n) bool (diagonal included — what
    ``core.gsofa.dense_pattern`` returns) or a ``storage.CSCPattern``; the
    sparse form keeps scheduling O(nnz(L+U)) for the packed storage path.
    ``n_bins``: pack_panels bin count for within-level grouping (clamped to
    the panel count so small problems don't over-provision).
    """
    if not isinstance(pattern, CSCPattern):
        pattern = CSCPattern.from_dense(pattern)
    n = pattern.n
    supernodes = _validate_supernodes(supernodes, n)
    k = len(supernodes)

    sup_of_col = np.repeat(np.arange(k, dtype=np.int64),
                           supernodes[:, 1] - supernodes[:, 0])
    col_counts = pattern.below_diag_counts()

    ancestors: List[np.ndarray] = []
    level = np.zeros(k, dtype=np.int64)
    for j, (s, e) in enumerate(supernodes):
        seg = pattern.rowind[pattern.indptr[s]:pattern.indptr[e]]
        anc = np.unique(sup_of_col[seg[seg < s]])
        ancestors.append(anc)
        level[j] = level[anc].max() + 1 if len(anc) else 0

    partition = pack_panels(supernodes, col_counts,
                            max(1, min(n_bins, k)) if k else max(0, n_bins),
                            policy=policy)

    levels: List[np.ndarray] = []
    for lv in range(int(level.max()) + 1 if k else 0):
        members = np.flatnonzero(level == lv)
        # group by pack_panels bin (batch/placement unit), stable within bin
        order = np.lexsort((members, partition.assignment[members]))
        levels.append(members[order])

    return PanelSchedule(supernodes=supernodes, ancestors=ancestors,
                         level=level, levels=levels, partition=partition,
                         col_counts=col_counts)
