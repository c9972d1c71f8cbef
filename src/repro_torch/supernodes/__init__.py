"""Supernode detection: streamed column fingerprints (K2) -> vectorized
T2/T3 boundary tests -> balanced panel packing."""
from repro_torch.supernodes.balance import (
    PanelPartition, pack_panels, supernode_weights,
)
from repro_torch.supernodes.detect import (
    detect_from_fingerprints, merge_flags, ranges_from_flags,
    supernode_stats,
)
from repro_torch.supernodes.fingerprint import ColumnFingerprints, mix1, mix2

__all__ = [
    "PanelPartition", "pack_panels", "supernode_weights",
    "detect_from_fingerprints", "merge_flags", "ranges_from_flags",
    "supernode_stats", "ColumnFingerprints", "mix1", "mix2",
]
