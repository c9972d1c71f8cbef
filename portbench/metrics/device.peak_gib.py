"""``torch.cuda.max_memory_allocated()`` over one analysis, after
``reset_peak_memory_stats()``, in GiB."""


def read(obs):
    prof = obs.get("profile")
    if not prof or prof.get("peak_bytes") is None:
        return None
    return prof["peak_bytes"] / 2**30
