"""Device operations (kernels, copies, sets) in the traced stretch per
control step: what a compiled step launches."""


def read(run):
    if run.trace is None or run.trace["steps"] <= 0:
        return None
    return run.trace["device_ops"] / run.trace["steps"]
