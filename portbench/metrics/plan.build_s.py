"""Seconds of the plan build per analysis: the program's ``build_schedule``,
``gather_maps`` and ``solve_schedule`` spans from each traced analysis's
``plan.stats`` (host work on arrays the fixpoint already copied back; its
copies to the card are synchronous), averaged over the traced window."""

SPANS = ("build_schedule", "gather_maps", "solve_schedule")


def read(obs):
    walls = []
    for a in obs.get("analyses", []):
        nodes = [a["stats"].find(name) for name in SPANS]
        if all(node is None for node in nodes):
            continue
        walls.append(sum(node.total_s for node in nodes if node is not None))
    return sum(walls) / len(walls) if walls else None
