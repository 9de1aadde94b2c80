"""Seconds the program spent capturing CUDA graphs (warm-up included) by
the window's start: ``icem_torch.runtime.graphs.CAPTURE_SECONDS``."""


def read(run):
    return run.capture_s
