"""The whole control step's share of the FP32 peak in the host loop:
``step_mfu``'s reading, under the name that moves the host loop's own rate."""

from benchmark.roofline import step_mfu


def read(run):
    return step_mfu(run)
