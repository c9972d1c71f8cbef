"""Roofline-driven autotuning of the analyze-time knobs (host numpy, a copy
of the reference's tuner).

``model.py`` owns the roofline cost model — modeled seconds of one
supernodal panel from its GEMM shape against machine peaks plus a
per-dispatch overhead term; ``autotune.py`` sweeps candidate supernode
partitions (re-detected from the retained column fingerprints, so no
fixpoint re-run) through the structure-aware blocking merge pass
(``supernodes/blocking.py``) and freezes the winning knob values onto the
plan.  A caller may pass measured peaks *in*; without them the model uses
fixed constants, so autotune decisions stay deterministic across processes
(a pickled autotuned plan replays bitwise anywhere).
"""
from repro_torch.tune.model import RooflineCostModel, cost_model_for
from repro_torch.tune.autotune import (
    TuneReport, autotune_partition, choose_concurrency,
)

__all__ = [
    "RooflineCostModel", "cost_model_for",
    "TuneReport", "autotune_partition", "choose_concurrency",
]
