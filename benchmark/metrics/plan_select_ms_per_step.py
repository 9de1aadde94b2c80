"""Device ms per control step in the plan step's select phases: trajectory
cost, candidates, the best row, top-k and the refit, three CEM iterations:
the program's ``plan.select`` phase markers
(``icem_torch.runtime.metrics.device_phases``) over the traced stretch of
device episodes."""

from benchmark.metrics._phase import ms_per_step


def read(run):
    return ms_per_step(run, "plan.select")
