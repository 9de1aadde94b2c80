"""Device operations per control step in the host loop's traced stretch:
``device_ops_per_step``'s reading, under the name that moves the host
loop's own rate."""


def read(run):
    if run.trace is None or run.trace["steps"] <= 0:
        return None
    return run.trace["device_ops"] / run.trace["steps"]
