"""Vanilla CEM (MpcCemStd), the baseline that iCEM improves on.

Counterpart of ``icem_tpu/controllers/cem_std.py``:

- truncated-normal sampling: exact truncation at the action bounds, or
  Levine-style bounds (std clamped to half the distance to the bounds,
  truncation at +-2 sigma)
- no colored noise, no population decay, no elite reuse
- options: execute_best_elite (else execute the mean's first action),
  shift_means (else reset the mean to zeros each step), bounds_like_levine
- the same top-k refit with alpha momentum as iCEM

The truncated normal is drawn by the inverse CDF of a uniform draw
(``truncated_uniform`` then ``truncated_normal``); the uniforms come from the
``torch.Generator`` in the planner state, so they differ from the JAX
package's, and the tests inject the same uniforms into both. A plan step
makes no host round trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from icem_torch.controllers.icem import (action_bounds, best_candidate, top_k_ascending,
                                        validate_sampler_params)
from icem_torch.controllers.mpc_common import (ModelConsistencyMixin, PlannerCheckpointMixin,
                                              ShardedPlannerMixin)
from icem_torch.device import indexed, resolve_device
from icem_torch.models.base import rollout_open_loop, trajectory_cost
from icem_torch.runtime.graphs import Compiled
from icem_torch.runtime.seeding import Seeding

# the uniform draw of the inverse CDF stays off 0 and 1
_U_LOW, _U_HIGH = 1e-6, 1.0 - 1e-6


def truncated_uniform(generator: torch.Generator, shape):
    """The uniform draw of ``truncated_normal``, in [1e-6, 1 - 1e-6]."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return _U_LOW + u * (_U_HIGH - _U_LOW)


def truncated_normal(u, lower, upper, loc, scale):
    """N(loc, scale^2) truncated to [loc + lower*scale, loc + upper*scale],
    by the inverse CDF of the uniforms ``u``. ``lower`` and ``upper`` are in
    standard deviations (scipy's truncnorm convention)."""
    a = torch.special.ndtr(lower)
    b = torch.special.ndtr(upper)
    z = torch.special.ndtri(a + u * (b - a))
    # numeric safety at extreme truncation
    z = torch.clamp(z, lower, upper)
    return loc + z * scale


@dataclass(frozen=True)
class CemStdConfig:
    """Static vanilla-CEM hyperparameters (names and defaults as in the JAX
    package)."""

    horizon: int = 30
    num_simulated_trajectories: int = 40
    opt_iterations: int = 3
    cost_along_trajectory: str = "sum"
    use_env_reward_as_cost: bool = False
    alpha: float = 0.1
    elites_size: int = 10
    init_std: float = 0.5
    execute_best_elite: bool = True
    shift_means: bool = True
    bounds_like_levine: bool = False
    action_dim: int = 1
    action_low: tuple = (-1.0,)
    action_high: tuple = (1.0,)

    def __post_init__(self):
        if self.num_simulated_trajectories < 2:
            raise ValueError("At least two trajectories needed!")

    @property
    def num_elites(self) -> int:
        return max(2, min(self.elites_size, self.num_simulated_trajectories // 2))

    @property
    def model_evals_per_timestep(self) -> int:
        return self.num_simulated_trajectories * self.opt_iterations * self.horizon

    def bounds(self, device):
        """(low, high) as float32 tensors on ``device``, made once per device."""
        return action_bounds(self, indexed(device))


class CemStdState(NamedTuple):
    mean: torch.Tensor           # [h, d]
    std: torch.Tensor            # [h, d]
    generator: torch.Generator   # the planner's random stream
    # the sharded planner's rank streams (parallel/plan.py::RankStream)
    rank_stream: Optional[tuple] = None


class CemPlanResult(NamedTuple):
    action: torch.Tensor          # [d] executed action
    state: CemStdState            # planner state after the step
    expected_cost: torch.Tensor   # min cost of the last iteration
    best_actions: torch.Tensor    # [h, d] the last iteration's best plan
    best_last_obs: torch.Tensor   # [obs_dim] its final predicted obs


def _init_mean(cfg: CemStdConfig, low, high):
    return torch.zeros((cfg.horizon, cfg.action_dim), device=low.device) + (high + low) / 2.0


def _init_std(cfg: CemStdConfig, low, high):
    return (torch.ones((cfg.horizon, cfg.action_dim), device=low.device)
            * (high - low) / 2.0 * cfg.init_std)


def _bounds(cfg: CemStdConfig, mean, std, low, high):
    """Truncation bounds in standard deviations, and the std (clamped under
    Levine's bounds)."""
    if cfg.bounds_like_levine:
        lb_dist, ub_dist = mean - low, high - mean
        std = torch.clamp(torch.minimum(torch.minimum(lb_dist / 2, ub_dist / 2), std), min=1e-8)
        return torch.full_like(mean, -2.0), torch.full_like(mean, 2.0), std
    lower = (low - mean) / (std + 1e-8)
    upper = (high - mean) / (std + 1e-8)
    return lower, upper, std


def init_state(cfg: CemStdConfig, generator: torch.Generator) -> CemStdState:
    """Fresh planner state on the generator's device."""
    low, high = cfg.bounds(generator.device)
    return CemStdState(mean=_init_mean(cfg, low, high), std=_init_std(cfg, low, high),
                       generator=generator)


def plan_step(cfg: CemStdConfig, predict_fn, cost_fn, pstate: CemStdState, obs,
              model_state, model_params=None) -> CemPlanResult:
    """One env step of vanilla-CEM planning: opt_iterations rounds of
    sample, roll out, rank and refit, then execute and shift.

    ``best_*`` are the LAST iteration's argmin, not the best over all
    iterations, as in the JAX package. ``model_params``: a learned model's
    weights, bound into its ``apply_fn`` (see icem.plan_step)."""
    if model_params is not None:
        predict_fn = partial(predict_fn, model_params)
    mean, std, gen = pstate.mean, pstate.std, pstate.generator
    low, high = cfg.bounds(mean.device)
    shape = (cfg.num_simulated_trajectories, cfg.horizon, cfg.action_dim)
    best_actions = best_cost = best_last_obs = None

    for _ in range(cfg.opt_iterations):
        lower, upper, std = _bounds(cfg, mean, std, low, high)
        actions = truncated_normal(truncated_uniform(gen, shape), lower, upper, mean, std)

        traj = rollout_open_loop(predict_fn, model_state, obs, actions)
        costs = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                cfg.use_env_reward_as_cost)
        # non-finite costs rank last
        costs = torch.where(torch.isfinite(costs), costs, float("inf"))
        best_actions, best_cost, best_last_obs = best_candidate(
            actions, costs, traj.next_observations[-1])

        elites = actions[top_k_ascending(costs, cfg.num_elites)]
        mean = (1 - cfg.alpha) * torch.mean(elites, dim=0) + cfg.alpha * mean
        std = (1 - cfg.alpha) * torch.std(elites, dim=0, correction=0) + cfg.alpha * std

    executed = best_actions[0] if cfg.execute_best_elite else mean[0]
    if cfg.shift_means:
        # Levine's bounds append a zero action, the exact ones repeat the last
        last = torch.zeros_like(mean[-1:]) if cfg.bounds_like_levine else mean[-1:]
        mean = torch.cat([mean[1:], last], dim=0)
    else:
        mean = torch.zeros_like(mean)
    std = _init_std(cfg, low, high)
    return CemPlanResult(action=executed, state=CemStdState(mean, std, gen),
                         expected_cost=best_cost, best_actions=best_actions,
                         best_last_obs=best_last_obs)


_CEM_STD_SAMPLER_KEYS = ("alpha", "elites_size", "opt_iterations", "init_std",
                         "execute_best_elite", "shift_means", "bounds_like_levine")


class MpcCemStd(ModelConsistencyMixin, PlannerCheckpointMixin, ShardedPlannerMixin):
    """Controller with the reference API around ``plan_step`` and its state
    (``verbose`` and ``sharded`` as in ``MpcICem``)."""

    needs_forward_model = True
    _shape_fields = ("horizon", "action_dim")

    def __init__(self, *, env, forward_model, action_sampler_params=None,
                 horizon=30, num_simulated_trajectories=40, factor_decrease_num=1,
                 cost_along_trajectory="sum", use_env_reward_as_cost=False,
                 verbose=False, do_visualize_plan=False, seed: Optional[int] = None,
                 sharded=False, device=None, **kwargs):
        if float(factor_decrease_num) != 1.0:
            # vanilla CEM has no population decay: such a config is meant for
            # mpc-icem and would otherwise run silently without it
            raise ValueError(
                f"factor_decrease_num={factor_decrease_num} has no effect on "
                f"mpc-cem-std (no population decay); use mpc-icem, or drop the key")
        asp = dict(action_sampler_params or {})
        validate_sampler_params(asp, _CEM_STD_SAMPLER_KEYS)
        self.env = env
        self.forward_model = forward_model
        self.device = resolve_device(device)
        self.cfg = CemStdConfig(
            horizon=horizon,
            num_simulated_trajectories=num_simulated_trajectories,
            cost_along_trajectory=cost_along_trajectory,
            use_env_reward_as_cost=use_env_reward_as_cost,
            action_dim=env.action_space.dim,
            action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
            action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()),
            **{k: asp[k] for k in _CEM_STD_SAMPLER_KEYS if k in asp},
        )
        from icem_torch.parallel.plan import resolve_group
        self._group = resolve_group(sharded, getattr(forward_model, "num_parallel", 0) or 0,
                                    self.device)
        self._announce_group()
        self._compiled_plan = None
        self.verbose = bool(verbose)
        self._seed = seed
        self._pstate: Optional[CemStdState] = None
        self._model_state = None
        self.was_reset = False
        self.last_expected_cost = None

    @property
    def model_evals_per_timestep(self):
        return self.cfg.model_evals_per_timestep

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _plan_impl(self):
        """(pstate, obs, model_state, model_params) -> CemPlanResult:
        ``plan_step`` as a compiled step (``runtime/graphs.py``), or
        ``cem_plan_step_sharded`` over the controller's group (see
        MpcICem._plan_impl)."""
        if self._compiled_plan is None:
            if self._group is None:
                self._compiled_plan = Compiled(
                    partial(plan_step, self.cfg, self._planner_fn(), self.env.cost_fn),
                    in_place=(3,), reads=self.forward_model.graph_reads, name="MpcCemStd.plan_step")
            else:
                from icem_torch.parallel.plan import ShardedPlan, cem_plan_step_sharded
                self._compiled_plan = ShardedPlan(
                    cem_plan_step_sharded, self.cfg, self._planner_fn(), self.env.cost_fn,
                    self._group, self.device, compiled=not self.plans_eagerly,
                    reads=self.forward_model.graph_reads, name="MpcCemStd.plan_step_sharded")
        return self._compiled_plan

    def beginning_of_rollout(self, *, observation, state=None, mode="train"):
        gen = Seeding.controller_generator(self._seed, "controller/cem-std", self.device)
        self._pstate = self.init_plan_state(int(np.shape(observation)[-1]), gen)
        self._model_state = self.forward_model.got_actual_observation_and_env_state(
            observation=self._as_tensor(observation),
            env_state=None if state is None else self._as_tensor(state),
            model_state=None)
        self.was_reset = True

    def end_of_rollout(self, total_time, total_return, mode):
        pass

    def get_action(self, obs, state=None, mode="train"):
        if not self.was_reset:
            raise AttributeError("beginning_of_rollout() needs to be called before")
        obs = self._as_tensor(obs)
        state = None if state is None else self._as_tensor(state)
        if self.verbose:
            self.check_model_consistency(state)
        self._model_state = self.forward_model.got_actual_observation_and_env_state(
            observation=obs, env_state=state, model_state=self._model_state)
        result = self._plan_impl()(self._pstate, obs, self._model_state,
                                   self.live_model_params)
        self._pstate = result.state
        self.last_expected_cost = result.expected_cost
        self._after_action(obs, result.action)
        return result.action.cpu().numpy()

    # -- functional interface for device-side episode loops ------------------
    def init_plan_state(self, obs_dim: int, generator: torch.Generator) -> CemStdState:
        """A fresh planner state (see MpcICem.init_plan_state)."""
        pstate = init_state(self.cfg, generator)
        if self._group is None:
            return pstate
        from icem_torch.parallel.plan import init_rank_stream
        return pstate._replace(rank_stream=init_rank_stream(generator))

    def train(self, buffer):
        return {}
