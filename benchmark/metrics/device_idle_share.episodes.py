"""The device idle share of a traced stretch of device episodes, percent:
1 - the union of device activity over the stretch."""


def read(run):
    if run.path != "device" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
