"""1 - (merged device-busy time) / wall, over one profiled analysis."""


def read(obs):
    prof = obs.get("profile")
    if not prof or not prof["events"] or not prof["wall_s"]:
        return None
    return 1.0 - prof["busy_s"] / prof["wall_s"]
