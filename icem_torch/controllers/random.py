"""Random controllers.

Counterpart of ``icem_tpu/controllers/random.py``:

- RndController: model-free uniform-random policy that holds each action
  for ``action_change_frequency`` steps
- MpcRandom: random shooting: uniform action sequences held for
  ``action_change_frequency`` steps, simulated through the forward model;
  it executes the first action of the cheapest

Randomness comes from an explicit ``torch.Generator``, so the draws differ
from the JAX package's. Neither controller's functional plan makes a host
round trip: the redraw schedule is fixed, so its counter is a Python int. On
the card the draws and the random shooting's plan step are compiled steps
(``runtime/graphs.py``); in a device episode the counter is a static leaf of
the captured control step, which picks its draw or hold graph.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import torch

from icem_torch.controllers.icem import best_candidate, validate_sampler_params
from icem_torch.controllers.mpc_common import ModelConsistencyMixin
from icem_torch.device import resolve_device
from icem_torch.models.base import rollout_open_loop, trajectory_cost
from icem_torch.runtime.checkpoint import pack_pytree, unpack_pytree
from icem_torch.runtime.graphs import Compiled
from icem_torch.runtime.seeding import Seeding


def sample_held_action_sequences(generator: torch.Generator, low, high, num_traj: int,
                                 horizon: int, change_every: int):
    """[p, h, d] uniform sequences whose action changes every
    ``change_every`` steps."""
    n_blocks = -(-horizon // change_every)
    u = torch.rand((num_traj, n_blocks, low.shape[-1]), generator=generator,
                   device=generator.device)
    blocks = low + u * (high - low)
    return torch.repeat_interleave(blocks, change_every, dim=1)[:, :horizon]


def _save(path, state: dict):
    with open(path, "wb") as f:
        pickle.dump(pack_pytree(state), f)


def _load(path, device) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return unpack_pytree(pickle.load(f), device)


class RndController:
    """Model-free uniform-random policy, each action held for
    ``action_change_frequency`` steps."""

    needs_forward_model = False

    def __init__(self, *, env, action_change_frequency: int = 1,
                 seed: Optional[int] = None, device=None, **kwargs):
        self.env = env
        self.action_change_frequency = int(action_change_frequency)
        self.device = resolve_device(device)
        self._generator = Seeding.controller_generator(seed, "controller/rnd", self.device)
        self._counter = 0
        self._current = None
        self._sample = Compiled(env.action_space.sample, name="RndController.sample")

    def get_action(self, obs, state=None, mode="train"):
        if self._current is None or self._counter >= self.action_change_frequency:
            self._current = self._sample(self._generator).cpu().numpy()
            self._counter = 0
        self._counter += 1
        return self._current

    def beginning_of_rollout(self, *, observation, state=None, mode="train"):
        self._counter = 0
        self._current = None

    def end_of_rollout(self, total_time, total_return, mode):
        pass

    # -- functional interface for device-side episode loops ------------------
    # the plan state is (generator, steps since the last draw, held action)
    def init_plan_state(self, obs_dim: int, generator: torch.Generator):
        # the counter starts saturated, so step 0 draws a fresh action
        return (generator, self.action_change_frequency,
                torch.zeros(self.env.action_space.dim, device=generator.device))

    def functional_plan(self):
        sample, freq = self._sample, self.action_change_frequency

        def plan(ps, obs, env_state, model_params=None):
            generator, count, current = ps
            if count >= freq:
                current, count = sample(generator), 0
            return current, (generator, count + 1, current)

        return plan

    @property
    def live_model_params(self):
        return None

    def train(self, buffer):
        return {}

    def save(self, path):
        """The generator and the held action: a resumed controller's next
        action equals this one's."""
        _save(path, {"generator": self._generator, "counter": self._counter,
                     "current": self._current})

    def load(self, path):
        state = _load(path, self.device)
        if state is not None:
            self._generator = state["generator"]
            self._counter = int(state["counter"])
            self._current = state["current"]


class MpcRandom(ModelConsistencyMixin):
    """Random-shooting MPC (``verbose`` as in ``MpcICem``)."""

    needs_forward_model = True

    def __init__(self, *, env, forward_model, horizon=30,
                 num_simulated_trajectories=40, cost_along_trajectory="sum",
                 use_env_reward_as_cost=False, action_sampler_params=None,
                 factor_decrease_num=1, verbose=False, do_visualize_plan=False,
                 seed: Optional[int] = None, device=None, **kwargs):
        if num_simulated_trajectories < 2:
            raise ValueError("At least two trajectories needed!")
        asp = dict(action_sampler_params or {})
        validate_sampler_params(asp, ("action_change_frequency",))
        self.env = env
        self.forward_model = forward_model
        self.device = resolve_device(device)
        self.horizon = int(horizon)
        self.num_sim_traj = int(num_simulated_trajectories)
        self.cost_along_trajectory = cost_along_trajectory
        self.use_env_reward_as_cost = bool(use_env_reward_as_cost)
        self.action_change_frequency = int(asp.get("action_change_frequency", 1))
        if self.action_change_frequency >= self.horizon:
            raise ValueError("action_change_frequency must be < horizon")
        self.verbose = bool(verbose)
        self._seed = seed
        self._generator = None
        self._model_state = None
        self.last_expected_cost = None
        self._compiled_plan = Compiled(self._plan_step, reads=self.forward_model.graph_reads,
                                       name="MpcRandom.plan_step")

    @property
    def model_evals_per_timestep(self):
        return self.num_sim_traj * self.horizon

    def plan_step(self, generator: torch.Generator, obs, model_state):
        """(first action of the cheapest sequence, its cost), through the
        model's ``predict_fn`` (a learned model's is bound to its live
        weights), as a compiled step."""
        return self._compiled_plan(generator, obs, model_state)

    def _plan_step(self, generator: torch.Generator, obs, model_state):
        low, high = self.env.action_space.bounds(obs.device)
        actions = sample_held_action_sequences(generator, low, high, self.num_sim_traj,
                                               self.horizon, self.action_change_frequency)
        traj = rollout_open_loop(self.forward_model.predict_fn, model_state, obs, actions)
        costs = trajectory_cost(self.env.cost_fn, traj, self.cost_along_trajectory,
                                self.use_env_reward_as_cost)
        # non-finite costs rank last
        costs = torch.where(torch.isfinite(costs), costs, float("inf"))
        best_actions, cost, _ = best_candidate(actions, costs, traj.next_observations[-1])
        return best_actions[0], cost

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def beginning_of_rollout(self, *, observation, state=None, mode="train"):
        self._generator = Seeding.controller_generator(self._seed, "controller/mpc-random",
                                                       self.device)
        self._model_state = self.forward_model.got_actual_observation_and_env_state(
            observation=self._as_tensor(observation),
            env_state=None if state is None else self._as_tensor(state),
            model_state=None)

    def end_of_rollout(self, total_time, total_return, mode):
        pass

    def get_action(self, obs, state=None, mode="train"):
        if self._generator is None:
            raise AttributeError("beginning_of_rollout() needs to be called before")
        obs = self._as_tensor(obs)
        state = None if state is None else self._as_tensor(state)
        if self.verbose:
            self.check_model_consistency(state)
        self._model_state = self.forward_model.got_actual_observation_and_env_state(
            observation=obs, env_state=state, model_state=self._model_state)
        action, self.last_expected_cost = self.plan_step(self._generator, obs,
                                                         self._model_state)
        self._after_action(obs, action)
        return action.cpu().numpy()

    # -- functional interface for device-side episode loops ------------------
    def init_plan_state(self, obs_dim: int, generator: torch.Generator):
        return generator

    def functional_plan(self):
        init_model_state = self.forward_model.init_model_state

        def plan(generator, obs, env_state, model_params=None):
            action, _ = self.plan_step(generator, obs, init_model_state(obs, env_state))
            return action, generator

        return plan

    @property
    def live_model_params(self):
        """None, as in the JAX package: the plan reads a learned model's live
        weights through its ``predict_fn``."""
        return None

    def train(self, buffer):
        return {}

    def save(self, path):
        """The generator and the synced model state."""
        _save(path, {"generator": self._generator, "model_state": self._model_state})

    def load(self, path):
        state = _load(path, self.device)
        if state is not None:
            self._generator = state["generator"]
            self._model_state = state["model_state"]
