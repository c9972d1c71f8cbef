"""CSC-panel working storage for the supernodal numeric LU (DESIGN.md §9).

The symbolic phase predicts the filled L+U structure, so numeric working
memory is allocated *from that prediction*: one contiguous ``(rows_J, w_J)``
float64 block per supernode panel J = [s, e), holding every structural row
of the panel's columns — U rows above the diagonal block, the packed L\\U
diagonal block, and the below-panel L rows:

    global rows          local layout of ``blocks[j]`` (sorted ascending)
    r0 < r1 < ... < s    [0 : diag[j]]          U(r, J) rows of ancestors
    s .. e-1             [diag[j] : diag[j]+w]  diagonal block (L\\U packed)
    rk > ... > e-1       [diag[j]+w : ]         below-panel L rows

The value-independent structure (rows, masks, offsets) is numpy on the host,
so a plan that holds a structure-only store pickles.  The values live on the
store's device in ONE flat float64 buffer; ``blocks[j]`` are views into it,
so zeroing, the CSR value scatter and the padding pass are single indexed
operations over the whole store instead of one launch per panel.

``CSCPattern`` is the sparse (per-column rows) form of the predicted L+U
pattern that the store and the scheduler consume; ``to_dense`` /
``dense_lu`` are test helpers — nothing on the factorization or solve path
materializes (n, n).

``BatchedPanelStore`` holds B value sets of one structure (the batched
tier): a (B, total) flat buffer whose rows start 512-byte aligned, so
``system(i)`` is a zero-copy ``PanelStore`` whose buffers sit at the same
alignment as a fresh store's (BLAS kernels may pick their code path by
pointer alignment, and the tier's per-system calls must be bitwise the
sequential ones).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSCPattern:
    """Per-column structural rows of the predicted L+U pattern.

    ``indptr``/``rowind`` follow compressed-sparse-column convention: column
    j's rows are ``rowind[indptr[j]:indptr[j+1]]``, strictly ascending, and
    the diagonal is always present.
    """

    n: int
    indptr: np.ndarray   # (n+1,) int64
    rowind: np.ndarray   # (nnz,) int64, sorted within each column

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def col(self, j: int) -> np.ndarray:
        return self.rowind[self.indptr[j]:self.indptr[j + 1]]

    @classmethod
    def from_dense(cls, pattern: np.ndarray) -> "CSCPattern":
        """From a dense bool (n, n) pattern (diagonal forced True)."""
        pattern = np.asarray(pattern, dtype=bool).copy()
        n = pattern.shape[0]
        if pattern.shape != (n, n):
            raise ValueError(f"pattern must be square, got {pattern.shape}")
        np.fill_diagonal(pattern, True)
        cols, rows = np.nonzero(pattern.T)      # column-major order
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, cols + 1, 1)
        return cls(n=n, indptr=np.cumsum(indptr),
                   rowind=rows.astype(np.int64))

    def below_diag_counts(self) -> np.ndarray:
        """(n,) strictly-below-diagonal count per column (pack weights)."""
        col_of = np.repeat(np.arange(self.n, dtype=np.int64),
                           np.diff(self.indptr))
        return np.bincount(col_of[self.rowind > col_of],
                           minlength=self.n).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        """Dense bool (n, n) — test helper only."""
        out = np.zeros((self.n, self.n), dtype=bool)
        col_of = np.repeat(np.arange(self.n), np.diff(self.indptr))
        out[self.rowind, col_of] = True
        return out


@dataclasses.dataclass(frozen=True)
class CsrScatterMaps:
    """Precomputed CSR -> packed-block scatter of one (matrix, store
    structure) pair, built once by ``PanelStore.csr_maps``.

    ``row_idx``/``col_idx``/``pos`` are parallel and grouped by target
    panel (``panel_ptr`` bounds): CSR slot ``pos[t]`` lands at
    ``blocks[j][row_idx[t], col_idx[t]]`` for ``panel_ptr[j] <= t <
    panel_ptr[j+1]``.  ``missed`` holds CSR positions whose (row, col) slot
    the store lacks — nonzero values there escape the symbolic prediction.
    """

    nnz: int
    panel_ptr: np.ndarray  # (n_panels+1,) int64 per-panel segment bounds
    row_idx: np.ndarray    # (hits,) int64 local block row
    col_idx: np.ndarray    # (hits,) int64 local block column
    pos: np.ndarray        # (hits,) int64 CSR value position
    missed: np.ndarray     # (misses,) int64 CSR positions with no slot


@dataclasses.dataclass(frozen=True)
class RowGather:
    """Device form of a ``(local index, hit mask)`` row map: rows ``sel``
    of a panel block land at rows ``pos`` of an ``m``-row result; rows not
    in ``pos`` are structural zeros.  ``pos`` is None when every requested
    row is present (the gather is then one ``index_select``)."""

    m: int
    sel: torch.Tensor
    pos: Optional[torch.Tensor]

    @classmethod
    def build(cls, idx: np.ndarray, hit: np.ndarray,
              device) -> "RowGather":
        sel = torch.as_tensor(idx[hit], dtype=torch.int64, device=device)
        pos = None
        if not hit.all():
            pos = torch.as_tensor(np.flatnonzero(hit), dtype=torch.int64,
                                  device=device)
        return cls(m=len(idx), sel=sel, pos=pos)


@dataclasses.dataclass(frozen=True)
class StoreIndex:
    """Device index tensors of one store structure, built once per
    (plan, device) and shared by every factorization on it:

    * ``csr_flat``/``csr_pos`` — flat block slots and CSR positions of the
      value scatter; ``missed`` the CSR positions with no slot (or None);
    * ``pad_flat`` — flat slots outside the per-column pattern (or None);
    * ``below[j]``/``above[j]`` — global rows of panel j's below-diagonal
      L rows and above-diagonal U rows (the substitution pushes), or None.
    """

    csr_flat: torch.Tensor
    csr_pos: torch.Tensor
    missed: Optional[torch.Tensor]
    pad_flat: Optional[torch.Tensor]
    below: List[Optional[torch.Tensor]]
    above: List[Optional[torch.Tensor]]


class PanelStore:
    """Packed CSC-panel working storage: one (rows_J, w_J) block per panel.

    Attributes
    ----------
    supernodes : (k, 2) int64 — contiguous [start, end) column ranges.
    rows : per-panel sorted global row ids; the diagonal rows s..e-1 are
        always present, so ``rows[j][diag[j]:diag[j]+w]`` == arange(s, e).
    in_pattern : per-panel bool mask of which block slots are in the
        *per-column* predicted pattern — False slots are panel padding.
    offsets : (k+1,) int64 flat offsets of the blocks in ``flat``.
    flat / blocks : the device values (None on a structure-only template);
        ``blocks[j]`` is a (len(rows[j]), w_j) view into ``flat``.
    sup_of_col : (n,) panel id of every column.
    """

    def __init__(self, pattern: CSCPattern, supernodes: np.ndarray, *,
                 device=None):
        supernodes = np.asarray(supernodes, dtype=np.int64)
        self.n = pattern.n
        self.pattern = pattern
        self.supernodes = supernodes
        k = len(supernodes)
        widths = supernodes[:, 1] - supernodes[:, 0]
        self.sup_of_col = np.repeat(np.arange(k, dtype=np.int64), widths)
        self.rows: List[np.ndarray] = []
        self.in_pattern: List[np.ndarray] = []
        self.diag = np.zeros(k, dtype=np.int64)
        for j, (s, e) in enumerate(supernodes):
            seg = pattern.rowind[pattern.indptr[s]:pattern.indptr[e]]
            rows = np.unique(np.concatenate([seg, np.arange(s, e)]))
            mask = np.zeros((len(rows), e - s), dtype=bool)
            for c in range(s, e):
                idx = np.searchsorted(rows, pattern.col(c))
                mask[idx, c - s] = True
            self.rows.append(rows)
            self.in_pattern.append(mask)
            self.diag[j] = np.searchsorted(rows, s)
        sizes = np.array([len(r) for r in self.rows], dtype=np.int64) * widths
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.index: Optional[StoreIndex] = None
        self.device = None
        self.flat: Optional[torch.Tensor] = None
        self.blocks: Optional[List[torch.Tensor]] = None
        if device is not None:
            self._bind(torch.zeros(int(self.offsets[-1]), dtype=torch.float64,
                                   device=device))

    def _bind(self, flat: torch.Tensor) -> None:
        """Take ``flat`` as the values; ``blocks`` become views into it."""
        self.device = flat.device
        self.flat = flat
        self.blocks = [
            flat[int(o):int(o) + len(r) * int(e - s)].view(len(r), int(e - s))
            for o, r, (s, e) in zip(self.offsets, self.rows, self.supernodes)]

    @classmethod
    def from_structure(cls, template: "PanelStore", device,
                       index: Optional[StoreIndex] = None,
                       flat: Optional[torch.Tensor] = None) -> "PanelStore":
        """A store sharing ``template``'s value-independent structure
        (read-only by contract): with newly allocated zero blocks on
        ``device`` — how ``LUPlan.factorize`` reuses one analysis across
        many factorizations — or, given ``flat``, a view of those values
        (``BatchedPanelStore.system``)."""
        new = cls.__new__(cls)
        for name in ("n", "pattern", "supernodes", "sup_of_col", "rows",
                     "in_pattern", "diag", "offsets"):
            setattr(new, name, getattr(template, name))
        new.index = index
        if flat is None:
            flat = torch.zeros(template.total_entries, dtype=torch.float64,
                               device=device)
        new._bind(flat)
        return new

    def __getstate__(self):
        # device values and index tensors never pickle with a plan's template
        state = dict(self.__dict__)
        state.update(flat=None, blocks=None, index=None, device=None)
        return state

    # -- sizing ------------------------------------------------------------
    @property
    def n_panels(self) -> int:
        return len(self.supernodes)

    @property
    def total_entries(self) -> int:
        """Allocated float64 slots across all panel blocks (incl. padding)."""
        return int(self.offsets[-1])

    @property
    def nbytes(self) -> int:
        return 8 * self.total_entries

    @property
    def pad_entries(self) -> int:
        """Slots outside the per-column pattern (panel-union padding)."""
        return int(self.total_entries - self.pattern.nnz)

    # -- device index --------------------------------------------------------
    def build_index(self, maps: CsrScatterMaps, device) -> StoreIndex:
        """Device index tensors of this structure (see ``StoreIndex``)."""
        widths = self.supernodes[:, 1] - self.supernodes[:, 0]
        panel_of = np.repeat(np.arange(self.n_panels, dtype=np.int64),
                             np.diff(maps.panel_ptr))
        csr_flat = (self.offsets[panel_of] + maps.row_idx * widths[panel_of]
                    + maps.col_idx)
        pad = [self.offsets[j] + np.flatnonzero(~m.ravel())
               for j, m in enumerate(self.in_pattern)]
        pad = np.concatenate(pad) if pad else np.zeros(0, np.int64)

        def dev(x):
            return (torch.as_tensor(x, dtype=torch.int64, device=device)
                    if len(x) else None)

        below, above = [], []
        for j, (s, e) in enumerate(self.supernodes):
            d = int(self.diag[j])
            below.append(dev(self.rows[j][d + int(e - s):]))
            above.append(dev(self.rows[j][:d]))
        return StoreIndex(
            csr_flat=torch.as_tensor(csr_flat, dtype=torch.int64,
                                     device=device),
            csr_pos=torch.as_tensor(maps.pos, dtype=torch.int64,
                                    device=device),
            missed=dev(maps.missed), pad_flat=dev(pad),
            below=below, above=above)

    # -- value scatter ------------------------------------------------------
    def csr_maps(self, a) -> CsrScatterMaps:
        """Precompute the CSR -> block scatter (value-independent)."""
        rows_a = np.repeat(np.arange(a.n, dtype=np.int64),
                           np.diff(a.indptr))
        cols_a = a.indices.astype(np.int64)
        order = np.argsort(self.sup_of_col[cols_a], kind="stable")
        ra, ca = rows_a[order], cols_a[order]
        bounds = np.searchsorted(self.sup_of_col[ca],
                                 np.arange(self.n_panels + 1))
        row_idx, col_idx, pos, missed = [], [], [], []
        panel_ptr = np.zeros(self.n_panels + 1, dtype=np.int64)
        for j, (s, e) in enumerate(self.supernodes):
            lo, hi = bounds[j], bounds[j + 1]
            hits = 0
            if lo < hi:
                idx_c, hit = self.local_rows(j, ra[lo:hi])
                row_idx.append(idx_c[hit])
                col_idx.append(ca[lo:hi][hit] - s)
                pos.append(order[lo:hi][hit])
                missed.append(order[lo:hi][~hit])
                hits = int(hit.sum())
            panel_ptr[j + 1] = panel_ptr[j] + hits

        def cat(parts):
            return (np.concatenate(parts).astype(np.int64) if parts
                    else np.zeros(0, dtype=np.int64))

        return CsrScatterMaps(nnz=int(a.nnz), panel_ptr=panel_ptr,
                              row_idx=cat(row_idx), col_idx=cat(col_idx),
                              pos=cat(pos), missed=cat(missed))

    def set_csr_mapped(self, values: torch.Tensor, maps: CsrScatterMaps, *,
                       zero: bool = True) -> torch.Tensor:
        """Scatter CSR-aligned ``values`` (a float64 (nnz,) tensor on the
        store's device) into the blocks, zeroing them first unless ``zero``
        is False (freshly allocated blocks).  Returns the largest |value|
        whose slot the store lacks, as a 0-d device tensor (no host sync)."""
        if values.shape != (maps.nnz,):
            raise ValueError(f"CSR values must be ({maps.nnz},), got "
                             f"{tuple(values.shape)}")
        if self.index is None:
            self.index = self.build_index(maps, self.device)
        if zero:
            self.flat.zero_()
        self.flat[self.index.csr_flat] = values[self.index.csr_pos]
        if self.index.missed is not None:
            return values[self.index.missed].abs().max()
        return values.new_zeros(())

    def diag_block(self, j: int) -> torch.Tensor:
        """The (w, w) packed L\\U diagonal block of panel j (a view)."""
        s, e = self.supernodes[j]
        d = int(self.diag[j])
        return self.blocks[j][d:d + int(e - s)]

    # -- row-index-mapped gathers -------------------------------------------
    def local_rows(self, j: int, take: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(local index, hit mask) of global rows ``take`` in panel j."""
        rows = self.rows[j]
        idx = np.searchsorted(rows, take)
        idx_c = np.minimum(idx, len(rows) - 1)
        return idx_c, rows[idx_c] == take

    def gather_rows_mapped(self, j: int, g: RowGather) -> torch.Tensor:
        """(g.m, w_j) dense gather of panel j through a device row map;
        rows absent from the panel's structure are structural zeros."""
        block = self.blocks[j]
        if g.pos is None:
            return block.index_select(0, g.sel)
        out = block.new_zeros((g.m, block.shape[1]))
        out[g.pos] = block.index_select(0, g.sel)
        return out

    # -- pattern-padding bookkeeping ---------------------------------------
    def padding_max(self) -> torch.Tensor:
        """Largest |value| on a padded slot (0-d device tensor)."""
        if self.index.pad_flat is None:
            return self.flat.new_zeros(())
        return self.flat[self.index.pad_flat].abs().max()

    def zero_padding(self) -> None:
        if self.index.pad_flat is not None:
            self.flat[self.index.pad_flat] = 0.0

    # -- dense reconstruction (test/oracle helpers) -------------------------
    def to_dense(self) -> np.ndarray:
        """Dense (n, n) L\\U working matrix on the host — test helper; the
        factorization and solve paths never call this."""
        out = np.zeros((self.n, self.n), dtype=np.float64)
        for j, (s, e) in enumerate(self.supernodes):
            out[self.rows[j], s:e] = self.blocks[j].cpu().numpy()
        return out

    def dense_lu(self) -> Tuple[np.ndarray, np.ndarray]:
        """(unit-lower L, upper U) dense host factors — for parity tests."""
        m = self.to_dense()
        return np.tril(m, -1) + np.eye(self.n), np.triu(m)


# float64 elements between the starts of two systems' rows of a batched
# buffer: 512 bytes, the card's allocation rounding and a multiple of the
# CPU allocator's 64-byte alignment
_ROW_ALIGN = 64


def batch_zeros(batch: int, shape, device,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Zero (batch, *shape) tensor whose every system slice ``[i]`` is
    contiguous and starts 512-byte aligned, as a fresh allocation of
    ``shape`` does: a BLAS call on a slice then sees the pointers the
    sequential path's call sees."""
    numel = math.prod(shape)
    stride = max(_ROW_ALIGN, -(-numel // _ROW_ALIGN) * _ROW_ALIGN)
    buf = torch.zeros((batch, stride), dtype=dtype, device=device)
    return buf[:, :numel].view(batch, *shape)


def batch_buffer(t: torch.Tensor) -> torch.Tensor:
    """The 1-D buffer under a (B, ...) tensor whose system slices are
    contiguous runs ``t.stride(0)`` apart from storage offset 0 (a
    ``batch_zeros`` tensor, or any contiguous one): system s's run starts
    at ``s * t.stride(0)``."""
    if t.storage_offset() != 0 or not t[0].is_contiguous():
        raise ValueError("batch_buffer needs contiguous system slices from "
                         "the start of the storage")
    return t.as_strided((t.shape[0] * t.stride(0),), (1,))


class BatchedPanelStore:
    """Packed CSC-panel storage for B same-pattern systems at once: one
    (B, rows_J, w_J) float64 block per panel, views into one (B, total)
    device buffer ``flat`` (rows 512-byte aligned, ``batch_zeros``), sharing
    the plan template's value-independent structure (rows / diag /
    in_pattern / pattern — read-only by contract) across the batch.

    The storage half of the many-matrix tier: circuit-style workloads
    factorize ONE sparsity pattern with many value sets (Newton iterations,
    transient sweeps, Monte Carlo corners), so the system axis is leading
    and gathers, scatters and the trailing updates run over it.
    ``system(i)`` is a zero-copy ``PanelStore`` over system i's values, on
    which the sequential solve and ``dense_lu`` run unchanged.
    """

    def __init__(self, template: PanelStore, batch: int, device,
                 index: Optional[StoreIndex] = None):
        if batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        self.batch = batch
        self.n = template.n
        self.template = template
        self.index = index
        self.device = torch.device(device)
        self.flat = batch_zeros(batch, (template.total_entries,), device)
        self.blocks: List[torch.Tensor] = [
            self.flat[:, int(o):int(o) + len(r) * int(e - s)].view(
                batch, len(r), int(e - s))
            for o, r, (s, e) in zip(template.offsets, template.rows,
                                    template.supernodes)]
        self._systems: List[Optional[PanelStore]] = [None] * batch
        self._solve_schedule = None     # the plan's, handed to system views

    # structure accessors delegate to the shared template
    @property
    def supernodes(self) -> np.ndarray:
        return self.template.supernodes

    @property
    def rows(self) -> List[np.ndarray]:
        return self.template.rows

    @property
    def diag(self) -> np.ndarray:
        return self.template.diag

    @property
    def in_pattern(self) -> List[np.ndarray]:
        return self.template.in_pattern

    @property
    def n_panels(self) -> int:
        return self.template.n_panels

    @property
    def total_entries(self) -> int:
        """Allocated float64 slots of ONE system."""
        return self.template.total_entries

    @property
    def nbytes(self) -> int:
        return 8 * self.batch * self.total_entries

    def system(self, i: int) -> PanelStore:
        """Zero-copy ``PanelStore`` of system ``i`` (built once, cached):
        its ``flat`` is ``flat[i]`` and its blocks are views into it."""
        if not 0 <= i < self.batch:
            raise IndexError(f"system {i} out of range for batch "
                             f"{self.batch}")
        if self._systems[i] is None:
            view = PanelStore.from_structure(self.template, self.device,
                                             self.index, flat=self.flat[i])
            view._solve_schedule = self._solve_schedule
            self._systems[i] = view
        return self._systems[i]

    def set_csr_mapped(self, values: torch.Tensor, maps: CsrScatterMaps, *,
                       zero: bool = True) -> torch.Tensor:
        """Scatter (B, nnz) CSR-aligned float64 ``values`` (on the store's
        device) into every system's blocks with one indexed copy — per
        system bitwise ``PanelStore.set_csr_mapped``.  Returns the (B,)
        per-system largest |value| whose slot the store lacks (device
        tensor, no host sync)."""
        if tuple(values.shape) != (self.batch, maps.nnz):
            raise ValueError(f"CSR values must be ({self.batch}, "
                             f"{maps.nnz}), got {tuple(values.shape)}")
        if self.index is None:
            self.index = self.template.build_index(maps, self.device)
        if zero:
            self.flat.zero_()
        self.flat[:, self.index.csr_flat] = values[:, self.index.csr_pos]
        if self.index.missed is not None:
            return values[:, self.index.missed].abs().amax(dim=1)
        return values.new_zeros(self.batch)

    def diag_block(self, j: int) -> torch.Tensor:
        """The (B, w, w) packed L\\U diagonal blocks of panel j (a view)."""
        s, e = self.supernodes[j]
        d = int(self.diag[j])
        return self.blocks[j][:, d:d + int(e - s)]

    def gather_rows_mapped(self, j: int, g: RowGather) -> torch.Tensor:
        """(B, g.m, w_j) gather of panel j through a device row map, in a
        ``batch_zeros`` buffer; per system bitwise
        ``PanelStore.gather_rows_mapped`` (absent rows are 0.0)."""
        block = self.blocks[j]
        out = batch_zeros(self.batch, (g.m, block.shape[2]), self.device)
        if g.pos is None:
            out.copy_(block.index_select(1, g.sel))
        else:
            out[:, g.pos] = block.index_select(1, g.sel)
        return out

    def padding_max(self) -> torch.Tensor:
        """(B,) per-system largest |value| on a padded slot (device)."""
        if self.index.pad_flat is None:
            return self.flat.new_zeros(self.batch)
        return self.flat[:, self.index.pad_flat].abs().amax(dim=1)

    def zero_padding(self) -> None:
        if self.index.pad_flat is not None:
            self.flat[:, self.index.pad_flat] = 0.0
