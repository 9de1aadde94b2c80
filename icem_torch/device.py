"""Device selection: entry points run on the card unless told otherwise."""

from __future__ import annotations

import numpy as np
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


def indexed(device) -> torch.device:
    """``device`` with its index: "cuda" and "cuda:0" name one card, and a
    cache of device constants keyed by either must hold them once."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(arrays, device, dtype=torch.float32) -> tuple:
    """Host arrays as ``dtype`` tensors on ``device``, through one copy: a
    copy to the card makes the host wait for it, so constants go over
    together. The tensors are views of one buffer."""
    host = [torch.as_tensor(np.asarray(a)).to(dtype) for a in arrays]
    packed = torch.cat([h.reshape(-1) for h in host]).to(device)
    out, start = [], 0
    for h in host:
        out.append(packed[start: start + h.numel()].view(h.shape))
        start += h.numel()
    return tuple(out)
