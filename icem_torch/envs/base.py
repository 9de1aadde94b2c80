"""Environment abstraction: explicit state tensors and batched pure methods.

Counterpart of ``icem_tpu/envs/base.py``. An env exposes ``init_state /
observation / step / cost_fn`` over an explicit state tensor; every method
that takes observations or states works over any leading batch dimensions,
so a population is one call. The env holds no device: its methods work on
the device of the tensors they are given, and ``init_state`` on the device
of its generator.

Action repeat (``action_repeat > 1``) wraps ``step`` and ``step_batched`` on
the instance, as the JAX constructor does, so every consumer (the episode
loops, the ground-truth model) sees the macro step; the raw single steps stay
reachable as ``_raw_step`` and ``_raw_step_batched``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from icem_torch.device import indexed, on_device
from icem_torch.envs.physics.render import render_planar


def uniform(generator: torch.Generator, shape, low: float, high: float):
    """A uniform draw in [low, high) on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + u * (high - low)


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

    def bounds(self, device):
        """(low, high) as tensors on ``device``, made once per device: a copy
        to the card at every draw would make the host wait for it."""
        cache = self.__dict__.setdefault("_device_bounds", {})
        device = indexed(device)
        if device not in cache:
            cache[device] = on_device((self.low, self.high), device)
        return cache[device]

    def sample(self, generator: torch.Generator):
        """A uniform draw on the generator's device."""
        low, high = self.bounds(generator.device)
        u = torch.rand(self.shape, generator=generator, device=generator.device)
        return low + u * (high - low)

    def clip(self, x):
        low, high = self.bounds(x.device)
        return torch.clamp(x, low, high)


@dataclass(frozen=True)
class DiscreteSpace:
    """Discrete action set exposed through a continuous embedding: n choices
    in [-1, 1], which an env rounds back to an index inside ``step``."""

    n: int

    @property
    def low(self):
        return np.array([-1.0], np.float32)

    @property
    def high(self):
        return np.array([1.0], np.float32)

    @property
    def shape(self):
        return (1,)

    @property
    def dim(self) -> int:
        return 1

    def sample(self, generator: torch.Generator):
        idx = torch.randint(0, self.n, (1,), generator=generator, device=generator.device)
        return self.embed(idx)

    def embed(self, index):
        """index in [0, n) -> continuous embedding in [-1, 1]."""
        return (index.to(torch.float32) + 0.5) * 2.0 / self.n - 1.0

    def index(self, action):
        """continuous action in [-1, 1] -> nearest index in [0, n)."""
        idx = torch.floor((action[..., 0] + 1.0) * 0.5 * self.n)
        return torch.clamp(idx, 0, self.n - 1).to(torch.int32)

    def clip(self, x):
        return torch.clamp(x, -1.0, 1.0)


def _repeated(raw_step, n: int):
    """``raw_step`` taken n times under the same action, rewards summed. Once
    a sub-step reports done, later sub-steps add no reward and leave the
    state and observation where they are (the alive mask)."""

    def step(state, action):
        state, obs, reward, done = raw_step(state, action)
        for _ in range(n - 1):
            new_state, new_obs, r, d = raw_step(state, action)
            alive = 1.0 - done
            state = state + alive[..., None] * (new_state - state)
            obs = obs + alive[..., None] * (new_obs - obs)
            reward = reward + alive * r
            done = torch.maximum(done, d)
        return state, obs, reward, done

    return step


class Env:
    """Environment over explicit state tensors.

    Subclasses define the spaces, ``init_state``, ``observation``, ``step``
    and ``cost_fn``. ``step_batched`` steps a population ``[P, ...]``.
    """

    name: str = "env"
    supports_state_from_obs: bool = True
    # the default cost's masked L2 distance to a goal state
    goal_state: Optional[np.ndarray] = None
    goal_mask: Optional[np.ndarray] = None
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
        self._raw_step = type(self).step.__get__(self)
        self._raw_step_batched = type(self).step_batched.__get__(self)
        if self.action_repeat > 1:
            self.step = _repeated(self._raw_step, self.action_repeat)
            self.step_batched = _repeated(self._raw_step_batched, self.action_repeat)

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
        """Population step over a leading axis. The analytic envs write their
        raw step over leading batch dimensions, so by default it is that;
        envs with a kernel override this."""
        return self._raw_step(states, actions)

    # -- costs ------------------------------------------------------------
    def cost_fn(self, observation, action, next_obs):
        """Default: the masked L2 distance to ``goal_state``."""
        if self.goal_state is None:
            raise NotImplementedError(f"{self.name} defines no goal_state; override cost_fn")
        goal, mask = self._constants(observation.device, self.goal_state, self.goal_mask)
        return torch.linalg.vector_norm((observation - goal) * mask, dim=-1)

    def reward_fn(self, observation, action, next_obs):
        return -self.cost_fn(observation, action, next_obs)

    def _constants(self, device, *arrays, dtype=torch.float32):
        """numpy constants of the env as tensors on ``device``, made once per
        device in one copy: a copy to the card inside a step would make the
        host wait for it at every step."""
        cache = self.__dict__.setdefault("_constant_cache", {})
        device = indexed(device)
        key = (device,) + tuple(id(a) for a in arrays)
        if key not in cache:
            cache[key] = (arrays, on_device(arrays, device, dtype))
        return cache[key][1]

    def state_from_observation(self, observation):
        """Reconstruct a dynamics state from an observation (GT-model entry)."""
        raise NotImplementedError(f"{self.name} cannot reconstruct state from observation")

    @staticmethod
    def compute_state_difference(state1, state2):
        """Largest absolute difference of two states, a 0-d tensor (states
        may be tensors or nested tuples and lists of them)."""
        def flat(state):
            if isinstance(state, (tuple, list)):
                return torch.cat([flat(x) for x in state])
            return torch.as_tensor(state).reshape(-1)

        return torch.max(torch.abs(flat(state1) - flat(state2)))

    def is_success(self, observation, action, next_obs):
        """Per-step success flag; None means the env has no success notion."""
        return None

    # -- rendering (host-side; never in the device hot path) ---------------
    def render_frame(self, state):
        """One RGB frame (uint8 [H,W,3]) of the given state, or None.

        Planar-engine envs render their kinematic skeleton by default; the
        spatial envs override this, and the envs without a model do not
        render. The frame is drawn on the host from one copy of q.
        """
        model = getattr(self, "model", None)
        if model is not None and hasattr(model, "ndof"):
            return render_planar(model, state[..., : model.ndof].cpu().numpy())
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


class MaskedGoalSpaceEnv(Env):
    """Goal-conditioned env whose goal and achieved goal are index sets of
    the observation, with a sparse (0/1 above ``threshold``) or dense
    (distance) cost and success on the next observation."""

    def __init__(self, *, goal_idx, achieved_goal_idx, sparse: bool, threshold: float = 0.1,
                 **kwargs):
        super().__init__(**kwargs)
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        self.goal_idx = np.asarray(goal_idx, np.int64)
        self.achieved_goal_idx = np.asarray(achieved_goal_idx, np.int64)
        self.sparse = bool(sparse)
        self.threshold = float(threshold)

    def _indices(self, device):
        """(goal, achieved goal) index tensors on ``device``."""
        return self._constants(device, self.goal_idx, self.achieved_goal_idx, dtype=torch.int64)

    def goal_from_observation(self, observations):
        return observations[..., self._indices(observations.device)[0]]

    def achieved_goal_from_observation(self, observations):
        return observations[..., self._indices(observations.device)[1]]

    def overwrite_goal(self, observations, goals):
        out = observations.clone()
        out[..., self._indices(observations.device)[0]] = goals
        return out

    def _goal_distance(self, observations):
        return torch.linalg.vector_norm(self.goal_from_observation(observations)
                                        - self.achieved_goal_from_observation(observations),
                                        dim=-1)

    def cost_fn(self, observation, action, next_obs):
        dist = self._goal_distance(observation)
        if self.sparse:
            return (dist > self.threshold).to(torch.float32)
        return dist

    def is_success(self, observation, action, next_obs):
        return (self._goal_distance(next_obs) <= self.threshold).to(torch.float32)
