"""The host loop's own share of a control step: the median of each step
less its ``get_action`` call, in ms, outside the profiled stretch."""

from benchmark.harness import median


def read(run):
    if run.path != "host":
        return None
    values = run.recorder.loop_ms(exclude_traced=True)
    return median(values) if values else None
