"""Cheap factorization-quality estimates: element growth, Hager 1-norm
condition, and a trust verdict.

A no-pivot (statically pivoted, possibly perturbed) factorization can
*complete* and still be garbage, so static pivoting trades the per-column
pivot search for a post-hoc certificate computed from what the packed
factors already hold, on their device:

* **Element growth** ``max|L\\U| / max|A_f|`` — the classic stability
  proxy (Wilkinson): large growth means elimination amplified roundoff.
* **Hager/Higham 1-norm condition estimate** — ``cond_1(A_f) ~
  ‖A_f‖₁ · est(‖A_f^{-1}‖₁)``, the inverse norm from a few forward and
  transposed solves on the packed factors (the LAPACK ``gecon``
  algorithm, O(nnz) per iterate).  The solves run on the factors' device;
  only the iteration's scalars come to the host.
* **Verdict** — "ok" / "suspect" / "reject" from fixed thresholds, so
  serving callers (``repro_torch.serve``) can gate answers.  The estimates
  describe the FACTORED system ``A_f = Dr·P·A·Dc``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.numeric.solve import (
    solve_factored, solve_factored_transposed,
)
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

#: Verdict thresholds.  cond_1 beyond ~1e10 leaves <6 float64 digits for
#: refinement to work with ("suspect"); beyond ~1e14 essentially none
#: ("reject").  Growth mirrors the same margins on the Wilkinson proxy.
COND_SUSPECT = 1e10
COND_REJECT = 1e14
GROWTH_SUSPECT = 1e6
GROWTH_REJECT = 1e10


@dataclasses.dataclass(frozen=True)
class QualityReport:
    """Trust certificate of one factorization (``LUFactorization.quality()``).

    ``verdict`` is "ok", "suspect" (perturbed pivots or moderate
    growth/conditioning — check the achieved residual before trusting), or
    "reject" (non-finite or hopeless conditioning — the solve should not be
    trusted even if it returns numbers).
    """

    growth: float              # max|L\U| / max|A_f| element growth
    cond_1_est: float          # Hager estimate of cond_1(A_f)
    norm1_a: float             # ‖A_f‖₁ (exact, from the factored values)
    perturbed_pivots: int      # tiny pivots bumped during the sweep
    verdict: str               # "ok" | "suspect" | "reject"

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"


def _verdict(growth: float, cond: float, perturbed: int) -> str:
    if (not np.isfinite(growth) or not np.isfinite(cond)
            or cond > COND_REJECT or growth > GROWTH_REJECT):
        return "reject"
    if perturbed > 0 or cond > COND_SUSPECT or growth > GROWTH_SUSPECT:
        return "suspect"
    return "ok"


def condest_1(num, norm1_a: float, *, itmax: int = 5) -> float:
    """Hager/Higham estimate of ``cond_1`` of the factored matrix:
    ``norm1_a * est(‖A_f^{-1}‖₁)`` via at most ``itmax`` rounds of one
    factored solve + one transposed solve each (the gecon iteration) on the
    factors' device.  The estimate is a lower bound, in practice within a
    small factor of the true norm."""
    n = num.n
    if n == 0:
        return 0.0
    dev = num.store.device
    x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    est = 0.0
    last_j = -1
    for _ in range(max(1, itmax)):
        y = solve_factored(num, x, batched=False)
        est = float(y.abs().sum())
        if not np.isfinite(est):
            return np.inf
        xi = torch.where(y >= 0.0, 1.0, -1.0).to(torch.float64)
        z = solve_factored_transposed(num, xi)
        za = z.abs()
        j = int(torch.argmax(za))
        if float(za[j]) <= float(z @ x) or j == last_j:
            break
        x = torch.zeros(n, dtype=torch.float64, device=dev)
        x[j] = 1.0
        last_j = j
    return est * norm1_a


def element_growth(num, factored_scale: float) -> float:
    """``max|L\\U| / max|A_f|`` over the packed store (padding is zeroed
    by the sweep, so the store max IS the factor max)."""
    flat = num.store.flat
    gmax = float(flat.abs().max()) if flat.numel() else 0.0
    if not np.isfinite(gmax):
        return np.inf
    return gmax / factored_scale if factored_scale > 0.0 else 0.0


def norm1_csr(a, factored_values: torch.Tensor) -> float:
    """Exact ‖A_f‖₁ (max column abs-sum) from CSR-aligned values on their
    device: each column summed in row order by ``segment_reduce`` (no
    atomics, so the same bits on every run)."""
    if not a.n:
        return 0.0
    cols = a.indices.astype(np.int64)
    order = np.argsort(cols, kind="stable")
    dev = factored_values.device
    sums = torch.segment_reduce(
        factored_values[torch.as_tensor(order, device=dev)].abs(), "sum",
        lengths=torch.as_tensor(np.bincount(cols, minlength=a.n),
                                device=dev), unsafe=True)
    return float(sums.max())


def estimate_quality(num, a_f, factored_values: torch.Tensor, *,
                     perturbed_pivots: int = 0,
                     itmax: int = 5) -> QualityReport:
    """Compute the full certificate for one factorization.

    ``num``: the ``NumericResult`` holding the packed factors;
    ``a_f``/``factored_values``: the structural matrix and CSR-aligned
    values (a float64 tensor on the factors' device) that were factored —
    the transformed system when static pivoting is on, the original
    otherwise.
    """
    with _ot.span("robust_quality"):
        norm1 = norm1_csr(a_f, factored_values)
        scale = (float(factored_values.abs().max())
                 if factored_values.numel() else 0.0)
        growth = element_growth(num, scale)
        cond = condest_1(num, norm1, itmax=itmax)
        report = QualityReport(growth=growth, cond_1_est=cond, norm1_a=norm1,
                               perturbed_pivots=int(perturbed_pivots),
                               verdict=_verdict(growth, cond,
                                                int(perturbed_pivots)))
        if _ot.ENABLED:
            reg = _om.registry()
            reg.gauge("robust.growth", growth if np.isfinite(growth) else -1.0)
            reg.gauge("robust.cond_estimate",
                      cond if np.isfinite(cond) else -1.0)
    return report
