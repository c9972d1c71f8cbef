"""Numerical robustness tier: static pivoting, tiny-pivot perturbation
support, and factorization-quality certificates.

The numeric sweep factors without pivoting on a pattern fixed at analyze
time; this package is what keeps that contract on indefinite and
row-permuted systems:

* ``build_robust_prepass`` / ``RobustPlan`` — the analyze-time
  maximum-product transversal + Ruiz equilibration (on the host) giving
  the ``A_f = Dr·P·A·Dc`` transform stored on the plan
  (``LUOptions(pivot="static")``); ``RobustPlan.on(device)`` is its
  device form (``DeviceRobust``).
* ``QualityReport`` / ``estimate_quality`` — element growth + Hager 1-norm
  condition estimate + trust verdict of a completed factorization, from
  solves on its device (``LUFactorization.quality()``).

Tiny-pivot perturbation itself lives with the pivot kernels
(``repro_torch.sparse.numeric.PerturbState``, ``LUOptions(perturb=True)``);
its counts surface here through the quality report.
"""
from repro_torch.robust.condition import (
    QualityReport, condest_1, element_growth, estimate_quality,
)
from repro_torch.robust.transversal import (
    DeviceRobust, RobustPlan, StructurallySingularError, build_robust_prepass,
    equilibrate, max_product_transversal,
)

__all__ = [
    "DeviceRobust",
    "QualityReport",
    "RobustPlan",
    "StructurallySingularError",
    "build_robust_prepass",
    "condest_1",
    "element_growth",
    "equilibrate",
    "estimate_quality",
    "max_product_transversal",
]
