"""Serving front end for the plan/factor session API.

``SolverEngine`` keeps a fingerprint-keyed LRU cache of ``LUPlan`` analyses
and packs queued (structure, values, rhs) requests into fixed-shape batched
``factorize_batch``/``solve_batch`` dispatches on the plan's device::

    from repro_torch.serve import SolverEngine

    eng = SolverEngine(repro_torch.LUOptions(concurrency=512),
                       batch_slots=8)
    rids = [eng.submit(a, vals, rhs) for vals, rhs in requests]
    results = eng.flush()          # one batched sweep per pattern chunk

Per-request results are bitwise those of the sequential
``analyze``/``factorize``/``solve`` calls.
"""
from repro_torch.serve.cache import PatternKey, PlanCache, pattern_fingerprint
from repro_torch.serve.engine import ServeRequest, ServeResult, SolverEngine

__all__ = [
    "PatternKey", "PlanCache", "pattern_fingerprint",
    "ServeRequest", "ServeResult", "SolverEngine",
]
