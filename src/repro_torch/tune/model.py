"""Roofline cost model for supernodal panel sweeps (host numpy, a copy of
the reference's model).

Models the seconds one panel costs the left-looking sweep from its packed
shape: a per-panel dispatch overhead ``alpha`` (host time per panel — the
dominant term for the thousands of tiny panels T2/T3 detection emits), the
trailing-update GEMM charged at ``max(flops / peak_flops, bytes / peak_bw)``
(the roofline), and the in-panel dense factor work.  The byte counts match
the analytic ``gemm.bytes`` accounting in ``numeric/supernodal.py``
(``8 * (m*k + k*w + 2*m*w)`` per panel).

Peaks come from the caller (a ``{"mem_bw_gbs", "flops_gflops"}`` dict);
without one the model uses the reference's fixed constants, so autotune
decisions are deterministic across hosts and processes and equal the
reference's — a pickled autotuned plan replays bitwise anywhere because the
chosen knobs are frozen onto the plan, not re-derived.

``backend="kernel"`` charges the padded shape the port's mapped K3/K4
launches (``kernels.ops.padded_gemm_shape``: its 128-thread tiles), not
the reference's MXU padding, so a kernel-backend partition may differ from
the reference's on purpose; the numpy backend pads nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.kernels import ops as _kops

# Fallback peaks when none are supplied: the reference's fixed constants
# (not a runtime probe), so the merge decisions they drive — which land on
# the plan — are the same on every host and every run, and the same as the
# reference's under the numpy backend.
DEFAULT_MEM_BW_GBS = 10.0
DEFAULT_FLOPS_GFLOPS = 50.0
# Per-panel dispatch overhead of the sweep (host loop and bookkeeping per
# panel), the reference's fixed value.
DEFAULT_DISPATCH_OVERHEAD_S = 5e-5


@dataclasses.dataclass(frozen=True)
class RooflineCostModel:
    """Modeled panel/GEMM seconds against machine peaks.

    ``backend`` selects the shape the GEMM is charged at: ``"numpy"`` uses
    logical shapes, ``"kernel"`` pads to the tiles the port's mapped K3/K4
    launches (``kernels.ops.padded_gemm_shape``; explicit-zero work is real
    work there).
    """

    mem_bw_gbs: float = DEFAULT_MEM_BW_GBS
    flops_gflops: float = DEFAULT_FLOPS_GFLOPS
    dispatch_overhead_s: float = DEFAULT_DISPATCH_OVERHEAD_S
    backend: str = "numpy"

    @classmethod
    def from_peaks(cls, peaks: Optional[dict], *, backend: str = "numpy",
                   dispatch_overhead_s: float = DEFAULT_DISPATCH_OVERHEAD_S,
                   ) -> "RooflineCostModel":
        """Build from a peaks dict (``mem_bw_gbs`` / ``flops_gflops``
        keys); missing keys fall back to the defaults."""
        peaks = peaks or {}
        return cls(
            mem_bw_gbs=float(peaks.get("mem_bw_gbs", DEFAULT_MEM_BW_GBS)),
            flops_gflops=float(peaks.get("flops_gflops",
                                         DEFAULT_FLOPS_GFLOPS)),
            dispatch_overhead_s=float(dispatch_overhead_s),
            backend=backend,
        )

    # -- primitive costs ---------------------------------------------------

    def gemm_time(self, m, k, n):
        """Roofline seconds of one ``(m, k) @ (k, n)`` trailing update.

        Bytes follow the sweep's analytic accounting: read L ``m*k``, read U
        ``k*n``, read+write the accumulator ``2*m*n``, 8 bytes each.
        Vectorised — accepts scalars or numpy arrays.
        """
        m_, k_, n_ = (np.asarray(x, dtype=np.float64) for x in (m, k, n))
        if self.backend == "kernel":
            mp, kp, np_ = _kops.padded_gemm_shape(m, k, n)
            m_, k_, n_ = (np.asarray(x, dtype=np.float64)
                          for x in (mp, kp, np_))
        flops = 2.0 * m_ * k_ * n_
        nbytes = 8.0 * (m_ * k_ + k_ * n_ + 2.0 * m_ * n_)
        t = np.maximum(flops / (self.flops_gflops * 1e9),
                       nbytes / (self.mem_bw_gbs * 1e9))
        return float(t) if np.ndim(t) == 0 else t

    def panel_time(self, m, k, w):
        """Modeled sweep seconds of one packed panel.

        ``m`` rows at/below the diagonal block, ``k`` ancestor rows above it
        (the GEMM reduction depth), ``w`` columns wide.  Sum of the dispatch
        overhead, the trailing GEMM at the roofline, and the in-panel dense
        factor charged at what the sweep actually runs: ``lu_inplace`` is a
        per-column rank-1 update loop, so the diagonal block rereads and
        rewrites its trailing submatrix every step — ``~16/3 w^3`` bytes of
        traffic, not one pass over ``w^2`` — and the below-diagonal rows get
        one triangular-solve pass (``(m - w) w^2`` flops, one read + write).
        The cubic byte term is what stops the merge pass at a finite width:
        dispatch savings shrink like ``1/w`` while factor traffic grows like
        ``w^2`` per column, giving ``w* = cbrt(3 alpha B / 32)`` (~36 cols
        at the default constants).  Vectorised over arrays.
        """
        m_, k_, w_ = (np.asarray(x, dtype=np.float64) for x in (m, k, w))
        t = self.dispatch_overhead_s + self.gemm_time(m, k, w)
        ml = np.maximum(m_ - w_, 0.0)  # L rows below the diagonal block
        factor_flops = (2.0 / 3.0) * w_ ** 3 + ml * w_ ** 2
        factor_bytes = (16.0 / 3.0) * w_ ** 3 + 16.0 * ml * w_
        t = t + np.maximum(factor_flops / (self.flops_gflops * 1e9),
                           factor_bytes / (self.mem_bw_gbs * 1e9))
        return float(t) if np.ndim(t) == 0 else t

    def partition_time(self, m, k, w):
        """Total modeled seconds of a whole partition (arrays per panel)."""
        return float(np.sum(self.panel_time(m, k, w)))


def cost_model_for(options, peaks: Optional[dict] = None) -> RooflineCostModel:
    """Model matching an ``LUOptions``' numeric backend, fed by ``peaks``
    when the caller measured them, or the fixed defaults otherwise."""
    return RooflineCostModel.from_peaks(
        peaks, backend=getattr(options, "numeric_backend", "numpy"))
