"""Device ms per control step in the plan step's rollout phases: B1 or B2 and
``rollout_open_loop``'s glue around it, three CEM iterations: the program's
``plan.rollout`` phase markers
(``icem_torch.runtime.metrics.device_phases``) over the traced stretch of
device episodes."""

from benchmark.metrics._phase import ms_per_step


def read(run):
    return ms_per_step(run, "plan.rollout")
