"""Blocking CUDA runtime calls (synchronisations, synchronous copies) in a
traced stretch of device episodes, per control step."""


def read(run):
    if run.path != "device" or run.trace is None or run.trace["steps"] <= 0:
        return None
    return run.trace["host_syncs"] / run.trace["steps"]
