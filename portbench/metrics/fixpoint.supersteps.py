"""Supersteps of the multi-source fixpoint per analysis (the program's own
exact count, ``plan.sym.supersteps``), averaged over the traced window."""


def read(obs):
    steps = [a["sym"].supersteps for a in obs.get("analyses", [])]
    return sum(steps) / len(steps) if steps else None
