"""B1's roofline share in the host loop: ``b1_roofline_share``'s reading,
under the name that moves the host loop's own rate."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run, "planar")
