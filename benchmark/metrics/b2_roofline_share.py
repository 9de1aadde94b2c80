"""B2, the spatial rollout kernel: its roofline bound over its traced device
time, percent (``roofline.kernel_share``)."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run, "spatial")
