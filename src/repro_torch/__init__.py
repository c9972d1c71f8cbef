"""repro_torch: the GSoFa sparse-LU pipeline on PyTorch, for one NVIDIA H100.

The port of ``repro`` (JAX/Pallas), module for module: the same plan/factor
session API, with every Pallas kernel on the main path rewritten by hand in
CUDA C++ for Hopper (``kernels/csrc``).  The default device is the card::

    import repro_torch

    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    factor = plan.factorize(values)        # numeric sweep on the card
    result = factor.solve(b)               # b: (n,) or (n, k)
    batch = plan.factorize_batch(values_batch)   # B value sets, one sweep

It imports torch, numpy and scipy — never jax and never ``repro``.
"""
__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "analyze": "repro_torch.api",
    "LUOptions": "repro_torch.api",
    "LUPlan": "repro_torch.api",
    "LUFactorization": "repro_torch.api",
    "BatchedLUFactorization": "repro_torch.api",
    "SymbolicResult": "repro_torch.core.symbolic",
    "NumericResult": "repro_torch.numeric",
    "BatchedNumericResult": "repro_torch.numeric",
    "SolveResult": "repro_torch.numeric",
    "BatchedSolveResult": "repro_torch.numeric",
    "PanelStore": "repro_torch.numeric",
    "BatchedPanelStore": "repro_torch.numeric",
    "CSCPattern": "repro_torch.numeric",
    "ZeroPivotError": "repro_torch.sparse.numeric",
    "CSRMatrix": "repro_torch.sparse",
}

__all__ = ["__version__", *_LAZY_EXPORTS]


def __getattr__(name):
    import importlib

    if name in _LAZY_EXPORTS:
        return getattr(importlib.import_module(_LAZY_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
