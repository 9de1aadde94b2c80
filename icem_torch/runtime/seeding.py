"""Seeding with named random streams.

Counterpart of ``icem_tpu/runtime/seeding.py``. Where the JAX package folds a
consumer's name into a PRNG key, this one seeds a ``torch.Generator`` from
the root seed and the name, so that adding a consumer never perturbs the
streams of the others. The streams differ from the JAX package's: the two
frameworks' generators give different numbers from one seed.
"""

from __future__ import annotations

import secrets
from typing import Optional

import numpy as np
import torch

from icem_torch.device import resolve_device


class Seeding:
    """Global seed registry: ``set_seed`` fixes the root seed,
    ``generator_for(name)`` gives the stream of one consumer."""

    SEED: Optional[int] = None
    _counters: dict = {}

    @classmethod
    def set_seed(cls, seed: Optional[int] = None, env=None) -> int:
        """Fix the root seed (a random one for None), seed numpy's global
        generator with it and hand it to ``env.seed`` where given."""
        if seed is None:
            seed = secrets.randbits(31)
        cls.SEED = int(seed)
        cls._counters = {}
        np.random.seed(cls.SEED & 0x7FFFFFFF)
        if env is not None and hasattr(env, "seed"):
            env.seed(cls.SEED)
        return cls.SEED

    @classmethod
    def root_seed(cls) -> int:
        if cls.SEED is None:
            cls.set_seed(None)
        return cls.SEED

    @classmethod
    def stream_seed(cls, name: str) -> int:
        """The 63-bit seed of the stream ``name``."""
        digest = int.from_bytes(name.encode(), "little") % (2**31 - 1)
        state = np.random.SeedSequence([cls.root_seed(), digest]).generate_state(2, np.uint32)
        return (int(state[0]) << 31) ^ int(state[1])

    @classmethod
    def generator_for(cls, name: str, device=None) -> torch.Generator:
        """A generator on ``device`` (the card unless told otherwise),
        independent per consumer name (``key_for`` in the JAX package)."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(cls.stream_seed(name))
        return gen

    @classmethod
    def next_generator(cls, kind: str, device=None) -> torch.Generator:
        """The stream of the n-th consumer of a kind (``next_key`` in the JAX
        package): with a fixed seed the i-th consumer always gets the same."""
        n = cls._counters.get(kind, 0)
        cls._counters[kind] = n + 1
        return cls.generator_for(f"{kind}/{n}", device)

    @classmethod
    def controller_generator(cls, seed: Optional[int], kind: str, device=None) -> torch.Generator:
        """A controller's stream: a generator seeded with ``seed`` where one
        is given, else the next stream of ``kind``."""
        if seed is None:
            return cls.next_generator(kind, device)
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return gen
