"""The controller: the median duration of ``MpcICem.get_action``, from its
call to the action on the host, in ms, outside the profiled stretch."""

from benchmark.harness import median


def read(run):
    if run.path != "host":
        return None
    values = run.recorder.plan_ms(exclude_traced=True)
    return median(values) if values else None
