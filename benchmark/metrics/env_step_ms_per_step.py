"""Device ms per control step in the device control step's env phase: the real
step, the termination freeze and the transition row (the plan's epilogue,
shifting the mean, falls in it too): the program's ``env.step`` phase
markers (``icem_torch.runtime.metrics.device_phases``) over the traced
stretch of device episodes."""

from benchmark.metrics._phase import ms_per_step


def read(run):
    return ms_per_step(run, "env.step")
