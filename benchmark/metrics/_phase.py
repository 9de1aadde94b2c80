"""The body the phase readers share (``plan_noise_ms_per_step.py`` and the
other ``*_ms_per_step.py``): device ms per control step in one phase of the
program's markers (``icem_torch.runtime.metrics.device_phases``), over the
traced stretch of device episodes. Not a metric: the harness loads a reader
by its metric's name, and no metric is named ``_phase``."""

from icem_torch.runtime import metrics


def ms_per_step(run, phase: str):
    """None where the program has no markers, none stamped ``phase``, or
    the run is not a traced run of device episodes."""
    phases = getattr(metrics, "device_phases", None)
    if phases is None or run.path != "device" or run.trace is None or run.trace["steps"] <= 0:
        return None
    per = phases()
    if not per or not per.get(phase):
        return None
    return sum(per[phase]) / run.trace["steps"]
