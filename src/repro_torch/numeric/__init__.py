"""Supernodal numeric LU on packed device storage + triangular solves.

schedule.py levels the panel DAG (numpy) -> storage.py holds one float64
block per panel on the plan's device -> supernodal.py factors level by level,
each level's trailing updates one in-place K3/K4 launch (float64, or float32
on the "kernel" backend) -> solve.py runs substitution + iterative
refinement.  The batched tier runs the same sweep over B value sets of
one plan (``BatchedPanelStore``, ``factor_batch_on_store``,
``solve_batch``).
"""
from repro_torch.numeric.schedule import (
    PanelMaps, PanelPlacement, PanelSchedule, build_gather_maps,
    build_placement, build_schedule,
)
from repro_torch.numeric.solve import (
    BatchedSolveResult, SolveResult, SolveSchedule, backward_substitute,
    backward_substitute_batch, build_solve_schedule, forward_substitute,
    forward_substitute_batch, solve, solve_batch, solve_factored,
    solve_factored_batch,
)
from repro_torch.numeric.storage import (
    BatchedPanelStore, CSCPattern, CsrScatterMaps, PanelStore,
)
from repro_torch.numeric.supernodal import (
    BatchedNumericResult, NumericResult, factor_batch_on_store,
    factor_on_store,
)

__all__ = [
    "PanelMaps", "PanelPlacement", "PanelSchedule", "build_gather_maps",
    "build_placement", "build_schedule",
    "BatchedSolveResult", "SolveResult", "SolveSchedule",
    "backward_substitute", "backward_substitute_batch",
    "build_solve_schedule", "forward_substitute", "forward_substitute_batch",
    "solve", "solve_batch", "solve_factored", "solve_factored_batch",
    "BatchedPanelStore", "CSCPattern", "CsrScatterMaps", "PanelStore",
    "BatchedNumericResult", "NumericResult", "factor_batch_on_store",
    "factor_on_store",
]
