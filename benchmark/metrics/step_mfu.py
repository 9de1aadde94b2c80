"""The whole control step: its rollout operations over the FP32 peak times
the traced time per step, percent (``roofline.step_mfu``)."""

from benchmark.roofline import step_mfu


def read(run):
    return step_mfu(run)
