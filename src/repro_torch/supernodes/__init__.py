"""Supernode detection: streamed column fingerprints (K2) -> vectorized
T2/T3 boundary tests -> balanced panel packing, and the structure-aware
blocking merge pass over a detected partition (``blocking.py``)."""
from repro_torch.supernodes.balance import (
    PanelPartition, pack_panels, supernode_weights,
)
from repro_torch.supernodes.blocking import (
    BlockingStats, merge_supernodes, partition_stats,
)
from repro_torch.supernodes.detect import (
    detect_from_fingerprints, detect_supernodes_batched, merge_flags,
    ranges_from_flags, supernode_stats,
)
from repro_torch.supernodes.fingerprint import (
    ColumnFingerprints, fingerprints_from_graph, mix1, mix2,
)

__all__ = [
    "PanelPartition", "pack_panels", "supernode_weights",
    "detect_from_fingerprints", "detect_supernodes_batched", "merge_flags",
    "ranges_from_flags", "supernode_stats", "ColumnFingerprints",
    "fingerprints_from_graph", "mix1", "mix2",
    "BlockingStats", "merge_supernodes", "partition_stats",
]
