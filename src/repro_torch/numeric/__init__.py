"""Supernodal numeric LU on packed device storage + triangular solves.

schedule.py levels the panel DAG (numpy) -> storage.py holds one float64
block per panel on the plan's device -> supernodal.py factors level by level,
each level's trailing updates one in-place K3/K4 launch (float64, or float32
on the "kernel" backend) -> solve.py runs substitution + iterative
refinement.
"""
from repro_torch.numeric.schedule import (
    PanelMaps, PanelSchedule, build_gather_maps, build_schedule,
)
from repro_torch.numeric.solve import (
    SolveResult, SolveSchedule, backward_substitute, build_solve_schedule,
    forward_substitute, solve, solve_factored,
)
from repro_torch.numeric.storage import CSCPattern, CsrScatterMaps, PanelStore
from repro_torch.numeric.supernodal import NumericResult, factor_on_store

__all__ = [
    "PanelMaps", "PanelSchedule", "build_gather_maps", "build_schedule",
    "SolveResult", "SolveSchedule", "backward_substitute",
    "build_solve_schedule", "forward_substitute", "solve", "solve_factored",
    "CSCPattern", "CsrScatterMaps", "PanelStore", "NumericResult",
    "factor_on_store",
]
