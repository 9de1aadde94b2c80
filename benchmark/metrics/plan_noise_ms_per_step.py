"""Device ms per control step in the plan step's noise phases: colored noise,
the shifted elites' last step and the simulation set, three CEM iterations:
the program's ``plan.noise`` phase markers
(``icem_torch.runtime.metrics.device_phases``) over the traced stretch of
device episodes."""

from benchmark.metrics._phase import ms_per_step


def read(run):
    return ms_per_step(run, "plan.noise")
