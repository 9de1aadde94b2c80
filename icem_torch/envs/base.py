"""Environment abstraction: explicit state tensors and batched pure methods.

Counterpart of ``icem_tpu/envs/base.py``. An env exposes ``init_state /
observation / step / cost_fn`` over an explicit state tensor; every method
that takes observations or states works over any leading batch dimensions,
so a population is one call. The env holds no device: its methods work on
the device of the tensors they are given, and ``init_state`` on the device
of its generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class BoxSpace:
    """Continuous action/observation bounds (gym.spaces.Box equivalent)."""

    low: np.ndarray
    high: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "low", np.asarray(self.low, np.float32))
        object.__setattr__(self, "high", np.asarray(self.high, np.float32))

    @property
    def shape(self):
        return self.low.shape

    @property
    def dim(self) -> int:
        return int(np.prod(self.low.shape))

    def _bounds(self, device):
        return (torch.as_tensor(self.low, device=device),
                torch.as_tensor(self.high, device=device))

    def sample(self, generator: torch.Generator):
        """A uniform draw on the generator's device."""
        low, high = self._bounds(generator.device)
        u = torch.rand(self.shape, generator=generator, device=generator.device)
        return low + u * (high - low)

    def clip(self, x):
        low, high = self._bounds(x.device)
        return torch.clamp(x, low, high)


class Env:
    """Environment over explicit state tensors.

    Subclasses define the spaces, ``init_state``, ``observation``, ``step``
    and ``cost_fn``. ``step_batched`` steps a population ``[P, ...]``.
    """

    name: str = "env"
    supports_state_from_obs: bool = True
    dt: float = 0.05

    observation_space: BoxSpace
    action_space: BoxSpace

    def __init__(self, *, name: Optional[str] = None, action_repeat: int = 1,
                 **kwargs):
        if name is not None:
            self.name = name
        self.action_repeat = int(action_repeat)
        if self.action_repeat < 1:
            raise ValueError(f"action_repeat must be >= 1, got {action_repeat}")

    # -- core dynamics ----------------------------------------------------
    def init_state(self, generator: torch.Generator, mode: str = "train"):
        """Initial ground-truth state for a fresh episode, on the
        generator's device."""
        raise NotImplementedError

    def observation(self, state):
        """Observation as a function of state (leading batch dims allowed)."""
        raise NotImplementedError

    def step(self, state, action):
        """One control step: (state, action) -> (next_state, obs, reward, done),
        ``done`` a float32 0/1 flag."""
        raise NotImplementedError

    def step_batched(self, states, actions):
        """Population step over a leading axis."""
        raise NotImplementedError

    # -- costs ------------------------------------------------------------
    def cost_fn(self, observation, action, next_obs):
        raise NotImplementedError

    def state_from_observation(self, observation):
        """Reconstruct a dynamics state from an observation (GT-model entry)."""
        raise NotImplementedError(f"{self.name} cannot reconstruct state from observation")

    def is_success(self, observation, action, next_obs):
        """Per-step success flag; None means the env has no success notion."""
        return None

    # -- misc --------------------------------------------------------------
    def get_fps(self) -> float:
        return 1.0 / (self.dt * self.action_repeat)

    def reset_with_mode(self, generator: torch.Generator, mode: str):
        """(state, observation) of a fresh episode, on the generator's device."""
        state = self.init_state(generator, mode)
        return state, self.observation(state)

    def seed(self, seed):  # host-API compatibility
        return seed

    def close(self):
        return None

    @property
    def obs_dim(self) -> int:
        return self.observation_space.dim

    @property
    def action_dim(self) -> int:
        return self.action_space.dim
