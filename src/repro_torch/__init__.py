"""repro_torch: the GSoFa sparse-LU pipeline on PyTorch, for one NVIDIA H100.

The port of ``repro`` (JAX/Pallas), module for module: the same plan/factor
session API, with every Pallas kernel on the main path rewritten by hand in
CUDA C++ for Hopper (``kernels/csrc``).  The default device is the card::

    import repro_torch

    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    factor = plan.factorize(values)        # numeric sweep on the card
    result = factor.solve(b)               # b: (n,) or (n, k)
    batch = plan.factorize_batch(values_batch)   # B value sets, one sweep

The robust tier (``LUOptions(pivot="static", perturb=True)``), structure-
aware blocking and the roofline autotune (``blocking``, ``autotune``,
``replan``) and the serving engine (``SolverEngine``) sit on the same
session API.  It imports torch, numpy and scipy — never jax and never
``repro``.
"""
__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "analyze": "repro_torch.api",
    "replan": "repro_torch.api",
    "LUOptions": "repro_torch.api",
    "LUPlan": "repro_torch.api",
    "LUFactorization": "repro_torch.api",
    "BatchedLUFactorization": "repro_torch.api",
    # roofline autotune + structure-aware blocking
    "RooflineCostModel": "repro_torch.tune",
    "TuneReport": "repro_torch.tune",
    "BlockingStats": "repro_torch.supernodes",
    # serving front end
    "SolverEngine": "repro_torch.serve",
    "PlanCache": "repro_torch.serve",
    "pattern_fingerprint": "repro_torch.serve",
    # numerical robustness tier
    "RobustPlan": "repro_torch.robust",
    "QualityReport": "repro_torch.robust",
    "StructurallySingularError": "repro_torch.robust",
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
