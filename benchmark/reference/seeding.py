"""The stream seeds of a run: the seed of a named random stream from the
run's root seed, as the program derives them, so that the reference draws
an episode's start state from the same stream as the program."""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(root: int, name: str) -> int:
    """The 63-bit seed of the stream ``name`` under the root seed ``root``."""
    digest = int.from_bytes(name.encode(), "little") % (2**31 - 1)
    state = np.random.SeedSequence([int(root), digest]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(root: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(root, name))
    return gen
