"""Streaming per-column structure fingerprints for supernode detection.

Row ``i`` of the filled pattern is exactly the converged label row of source
``i``, so the below-diagonal structure of every column of L can be
summarized *incrementally* as the multi-source driver streams per-chunk
converged ``maxId`` matrices (DESIGN.md §3).  Per column ``j`` we keep three
O(n) accumulators:

    counts[j] = |{ i > j : filled(i, j) }|         (below-diagonal nnz)
    hsum[j]   = sum_{i in that set} mix1(i)        (mod 2^32)
    hxor[j]   = xor_{i in that set} mix2(i)

plus ``subdiag[j] = filled(j, j-1)`` (the L(j, j-1) != 0 half of the T2
test).  All three column reductions are associative and commutative, so
chunks can arrive in any order and under any label-window offset.

The per-chunk column reduction is K2 (``kernels/ops.column_fingerprints``):
the CUDA kernel when the labels lie on the card, its plain version when they
lie on the CPU.  The accumulators themselves are O(n) numpy on the host, so
they pickle with a plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as _ot

_GOLDEN = np.uint64(2654435761)          # Knuth multiplicative hash
_MASK32 = np.uint64(0xFFFFFFFF)


def mix1(ids: np.ndarray) -> np.ndarray:
    """Multiplicative row hash, uint32 (wrapping)."""
    x = (np.asarray(ids, dtype=np.uint64) + 1) * _GOLDEN
    return (x & _MASK32).astype(np.uint32)


def mix2(ids: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 row hash — independent of mix1."""
    x = (np.asarray(ids, dtype=np.uint64) + 1) & _MASK32
    x ^= x >> 16
    x = (x * np.uint64(0x85EBCA6B)) & _MASK32
    x ^= x >> 13
    x = (x * np.uint64(0xC2B2AE35)) & _MASK32
    x ^= x >> 16
    return x.astype(np.uint32)


@dataclasses.dataclass
class ColumnFingerprints:
    """O(n) fingerprint state, filled row-chunk by row-chunk.

    ``update`` consumes a converged label matrix exactly as multisource emits
    it (offset-encoded, padded with repeated sources); rows already seen are
    ignored, so re-delivery (chunk padding, checkpoint replay) is idempotent.
    """

    n: int

    def __post_init__(self):
        self.counts = np.zeros(self.n, dtype=np.int64)
        self.hsum = np.zeros(self.n, dtype=np.uint32)
        self.hxor = np.zeros(self.n, dtype=np.uint32)
        self.subdiag = np.zeros(self.n, dtype=bool)
        self.seen = np.zeros(self.n, dtype=bool)

    @property
    def complete(self) -> bool:
        return bool(self.seen.all())

    def update(self, labels: torch.Tensor, srcs: np.ndarray,
               offset: int = 0) -> int:
        """Accumulate one converged chunk; returns #new rows consumed.

        labels: (G, W) int32 ``offset + maxId`` label tensor, W <= n.
        srcs:   (G,) source ids of the label rows (repeats allowed — padding).
        """
        if not _ot.ENABLED:
            return self._update(labels, srcs, offset)
        with _ot.span("fingerprint_update"):
            return self._update(labels, srcs, offset)

    def _update(self, labels: torch.Tensor, srcs: np.ndarray,
                offset: int = 0) -> int:
        srcs = np.asarray(srcs, dtype=np.int64)
        w = labels.shape[1]
        # first occurrence within the batch, then drop rows seen earlier
        _, first = np.unique(srcs, return_index=True)
        keep = first[~self.seen[srcs[first]]]
        if len(keep) == 0:
            return 0
        kept_srcs = srcs[keep]
        self.seen[kept_srcs] = True

        dev = labels.device
        lab = labels[torch.as_tensor(keep, device=dev)]
        # offset-free labels: maxId, or w+1 (> any real column) when the
        # label is uninitialized / stale arena garbage
        rel = torch.where(lab <= offset + w, lab - offset, w + 1)

        src_j = torch.as_tensor(kept_srcs.astype(np.int32), device=dev)
        # the uint32 hashes travel bit-for-bit as int32 lanes
        m1 = torch.as_tensor(mix1(kept_srcs).view(np.int32), device=dev)
        m2 = torch.as_tensor(mix2(kept_srcs).view(np.int32), device=dev)
        valid = torch.ones(len(keep), dtype=torch.int32, device=dev)
        part = kops.column_fingerprints(rel, src_j, m1, m2, valid)
        part = part.cpu().numpy()
        self.counts[:w] += part[0].astype(np.int64)
        self.hsum[:w] += part[1].view(np.uint32)
        self.hxor[:w] ^= part[2].view(np.uint32)

        # subdiag half of T2: filled(s, s-1) <=> maxId[s-1] < s-1
        rows = np.flatnonzero(kept_srcs >= 1)
        if len(rows):
            cols = kept_srcs[rows] - 1
            vals = rel[torch.as_tensor(rows, device=dev),
                       torch.as_tensor(cols, device=dev)].cpu().numpy()
            self.subdiag[kept_srcs[rows]] = vals < cols
        return len(keep)

    def merge(self, other: "ColumnFingerprints") -> "ColumnFingerprints":
        """Fold a disjoint shard's partial fingerprints into this one (each
        shard accumulates its own sources; partials merge associatively on
        the host — the oracle of ``runtime.collectives
        .merge_fingerprint_shards``)."""
        if self.n != other.n:
            raise ValueError(f"cannot merge fingerprints of n={other.n} "
                             f"into n={self.n}")
        overlap = self.seen & other.seen
        if overlap.any():
            raise ValueError(
                f"cannot merge overlapping fingerprint shards: rows "
                f"{np.flatnonzero(overlap)[:8].tolist()}... seen on both sides")
        self.counts += other.counts
        self.hsum += other.hsum
        self.hxor ^= other.hxor
        self.subdiag |= other.subdiag
        self.seen |= other.seen
        return self


def fingerprints_from_graph(graph, *, concurrency: int = 128,
                            backend: str = "ell", bubble: bool = False,
                            use_arena: bool = True) -> ColumnFingerprints:
    """Run the multi-source fixpoint on the graph's device purely to collect
    fingerprints (``symbolic_factorize(detect_supernodes=True)`` gets them
    from the same pass).  Bubble chunks hand K2 label chunks narrower than
    n."""
    from repro_torch.core.multisource import run_multisource

    fp = ColumnFingerprints(n=graph.n)
    run_multisource(graph, concurrency=concurrency, backend=backend,
                    bubble=bubble, use_arena=use_arena, on_chunk=fp.update)
    return fp
