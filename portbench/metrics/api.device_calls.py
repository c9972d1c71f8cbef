"""Device activities (kernels, copies, fills) of one profiled analysis:
what the host's launch rate is spent on."""


def read(obs):
    prof = obs.get("profile")
    return len(prof["events"]) if prof else None
