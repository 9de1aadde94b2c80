"""Device selection: entry points run on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on.

    ``None`` means the CUDA device, and raises ``RuntimeError`` where CUDA is
    absent: the port never moves to the CPU on its own. The CPU is used only
    when the caller passes it (``"cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "icem_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
