"""GSoFa core on PyTorch: the label fixpoint, its multi-source driver, the
label arena and the symbolic factorization entry point."""
from repro_torch.core.gsofa import (
    INF, SymbolicGraph, fill_masks, gsofa_batch, prepare_graph, row_counts,
)

__all__ = ["INF", "SymbolicGraph", "fill_masks", "gsofa_batch",
           "prepare_graph", "row_counts"]
