"""Sparse-matrix substrate: CSR containers, generators, ordering, numeric
helpers (host-side numpy/scipy, plus the device matvec and block LU)."""
from repro_torch.sparse.csr import (
    CSRMatrix, csr_from_coo, csr_from_dense, csr_to_ell, transpose_csr,
)
from repro_torch.sparse.matrices import (
    banded_full, banded_random, bordered_block_diagonal, chemical_like,
    circuit_like, economic_like, grid2d_laplacian, grid3d_laplacian,
    random_pattern,
)
from repro_torch.sparse.ordering import (
    natural_order, permute_csr, random_order, rcm_order,
)

__all__ = [
    "CSRMatrix", "csr_from_coo", "csr_from_dense", "csr_to_ell",
    "transpose_csr", "banded_full", "banded_random",
    "bordered_block_diagonal", "chemical_like", "circuit_like",
    "economic_like", "grid2d_laplacian", "grid3d_laplacian",
    "random_pattern", "natural_order", "permute_csr", "random_order",
    "rcm_order",
]
