"""iCEM — improved Cross-Entropy Method planner.

Counterpart of ``icem_tpu/controllers/icem.py``, with both of its CEM loops
(``cem_loop``): "unrolled" rolls out each iteration at its own decayed
population; "scan" rolls out every iteration at one fixed population and
masks the decayed rows instead (``_plan_step_scan``). Both have:

- colored-noise (1/f^beta) action sampling
- population decay: n_i = max(2*elites_size, int(n_{i-1} / gamma)), exact
  integers from the config, one rollout per CEM iteration at its own size
- shift-elites-over-time at iteration 0: elites' actions shifted one step
  with a freshly sampled last action, re-simulated
- keep-previous-elites at i>0: the top fraction re-enters the candidate set
  with its already-computed cost, not re-simulated
- add mean as a candidate in the last iteration
- clip-at-bounds sampling
- top-k elite refit with alpha-momentum on mean and std
- execute the best seen action of the final iteration, then shift the mean
  one step and reset std

Randomness comes from the ``torch.Generator`` in the planner state, drawn in
a fixed order, so a plan step is reproducible from its seed; the draws differ
from the JAX package's. A plan step makes no host round trip: the first step
of an episode masks its missing elites with a Python flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from icem_torch.controllers.mpc_common import (ModelConsistencyMixin, PlannerCheckpointMixin,
                                              ShardedPlannerMixin)
from icem_torch.device import indexed, on_device, resolve_device
from icem_torch.models.base import batch_tree, rollout_open_loop, trajectory_cost, unbatch_tree
from icem_torch.ops.colored_noise import sample_colored_action_noise
from icem_torch.runtime.graphs import Compiled
from icem_torch.runtime.metrics import mark_step, phase, span
from icem_torch.runtime.seeding import Seeding
from icem_torch.runtime.video import VideoRecorder


@dataclass(frozen=True)
class ICemConfig:
    """Static iCEM hyperparameters (names and defaults as in the JAX package)."""

    horizon: int = 30
    num_simulated_trajectories: int = 40
    factor_decrease_num: float = 1.25
    cost_along_trajectory: str = "sum"
    use_env_reward_as_cost: bool = False
    # action_sampler_params
    alpha: float = 0.1
    elites_size: int = 10
    opt_iterations: int = 3
    init_std: float = 0.5
    use_mean_actions: bool = True
    keep_previous_elites: bool = True
    shift_elites_over_time: bool = True
    fraction_elites_reused: float = 0.3
    noise_beta: float = 1.0
    # action space
    action_dim: int = 1
    action_low: tuple = (-1.0,)
    action_high: tuple = (1.0,)
    cem_loop: str = "unrolled"

    def __post_init__(self):
        if self.num_simulated_trajectories < 2:
            raise ValueError("At least two trajectories needed!")
        if self.cem_loop not in ("unrolled", "scan"):
            raise ValueError(f"cem_loop must be 'unrolled' or 'scan', "
                             f"got {self.cem_loop!r}")

    @property
    def num_elites(self) -> int:
        ne = min(self.elites_size, self.num_simulated_trajectories // 2)
        return max(ne, 2)

    @property
    def elites_kept(self) -> int:
        """Rows of elite memory reused per step."""
        return int(self.num_elites * self.fraction_elites_reused)

    @property
    def population_schedule(self) -> tuple:
        """Fresh-sample count per CEM iteration."""
        sizes = []
        n = self.num_simulated_trajectories
        for i in range(self.opt_iterations):
            if i > 0:
                n = max(self.elites_size * 2, int(n / self.factor_decrease_num))
            sizes.append(n)
        return tuple(sizes)

    @property
    def model_evals_per_timestep(self) -> int:
        return sum(
            max(self.elites_size * 2,
                int(self.num_simulated_trajectories / self.factor_decrease_num**i))
            for i in range(self.opt_iterations)
        ) * self.horizon

    def bounds(self, device):
        """(low, high) as float32 tensors on ``device``, made once per device:
        a copy from host memory would make the host wait for the card."""
        return action_bounds(self, indexed(device))


@lru_cache(maxsize=None)
def action_bounds(cfg, device: torch.device):
    """(low, high) of a config with ``action_low`` / ``action_high``, made
    once per config and device."""
    return on_device((cfg.action_low, cfg.action_high), device)


class ICemState(NamedTuple):
    """Planner state."""

    mean: torch.Tensor           # [h, d]
    std: torch.Tensor            # [h, d]
    elite_actions: torch.Tensor  # [K, h, d] sorted ascending by cost
    elite_costs: torch.Tensor    # [K]
    elite_last_obs: torch.Tensor  # [K, obs_dim] final predicted obs per elite
    have_elites: bool            # False until the first update
    generator: torch.Generator   # the planner's random stream
    # the sharded planner's rank streams (parallel/plan.py::RankStream)
    rank_stream: Optional[tuple] = None


class PlanResult(NamedTuple):
    action: torch.Tensor          # [d] executed action (best trajectory's first)
    state: ICemState              # planner state after the step
    expected_cost: torch.Tensor   # min cost of the final iteration
    best_actions: torch.Tensor    # [h, d] full best plan
    best_last_obs: torch.Tensor   # [obs_dim] best plan's final predicted obs


def init_mean(cfg: ICemConfig, device) -> torch.Tensor:
    """Center of the action space."""
    low, high = cfg.bounds(device)
    return torch.zeros((cfg.horizon, cfg.action_dim), device=device) + (high + low) / 2.0


def init_std(cfg: ICemConfig, device) -> torch.Tensor:
    """init_std * half action range."""
    low, high = cfg.bounds(device)
    return (torch.ones((cfg.horizon, cfg.action_dim), device=device)
            * (high - low) / 2.0 * cfg.init_std)


def init_state(cfg: ICemConfig, obs_dim: int, generator: torch.Generator) -> ICemState:
    """Fresh planner state on the generator's device."""
    device = generator.device
    K = cfg.num_elites
    return ICemState(
        mean=init_mean(cfg, device),
        std=init_std(cfg, device),
        elite_actions=torch.zeros((K, cfg.horizon, cfg.action_dim), device=device),
        elite_costs=torch.full((K,), float("inf"), device=device),
        elite_last_obs=torch.zeros((K, obs_dim), device=device),
        have_elites=False,
        generator=generator,
    )


def sample_action_sequences(cfg: ICemConfig, generator: torch.Generator, mean, std,
                            num_traj: int):
    """Colored-noise (or white) sampling, scaled, shifted and clipped to bounds."""
    if cfg.noise_beta > 0:
        noise = sample_colored_action_noise(
            generator, cfg.noise_beta, num_traj, cfg.horizon, cfg.action_dim)
    else:
        noise = torch.randn((num_traj, cfg.horizon, cfg.action_dim),
                            generator=generator, device=generator.device)
    low, high = cfg.bounds(mean.device)
    return torch.clamp(noise * std + mean, low, high)


def top_k_ascending(costs, k: int):
    """Indices of the k smallest costs, ascending, ties to the lower index.

    Non-finite costs, -inf included, rank last: they are divergence
    artifacts, not good trajectories. ``torch.topk`` does not promise an order
    among ties, so this is a stable sort's prefix.
    """
    costs = torch.where(torch.isfinite(costs), costs, float("inf"))
    return torch.argsort(costs, stable=True)[:k]


def _refit(cfg: ICemConfig, mean, std, cand_actions, cand_costs, cand_last_obs):
    """Elite selection + alpha-momentum distribution update.

    Returns (mean, std, elite_actions, elite_costs, elite_last_obs).
    """
    elite_idx = top_k_ascending(cand_costs, cfg.num_elites)
    elite_actions = cand_actions[elite_idx]
    elite_costs = cand_costs[elite_idx]
    elite_last_obs = cand_last_obs[elite_idx]

    new_mean = torch.mean(elite_actions, dim=0)
    new_std = torch.std(elite_actions, dim=0, correction=0)
    mean = (1.0 - cfg.alpha) * new_mean + cfg.alpha * mean
    std = (1.0 - cfg.alpha) * new_std + cfg.alpha * std
    return mean, std, elite_actions, elite_costs, elite_last_obs


def best_candidate(cand_actions, cand_costs, cand_last_obs):
    """The candidate at the first minimum cost: (actions, cost, last obs).

    Indexed by a one-element index tensor: a 0-d index tensor would be read
    back to the host (``Tensor.item``) and make the host wait for the card.
    """
    idx = torch.argmin(cand_costs, dim=0, keepdim=True)
    return cand_actions[idx][0], cand_costs[idx][0], cand_last_obs[idx][0]


def plan_step(cfg: ICemConfig, predict_fn, cost_fn, pstate: ICemState, obs,
              model_state, model_params=None) -> PlanResult:
    """One environment step of iCEM planning.

    predict_fn: batched (model_state, obs, action) -> (model_state, obs,
                reward), optionally with a whole-horizon ``.rollout``. With
                ``model_params`` it is a learned model's ``apply_fn``, which
                takes them first: the weights the caller reads at each call.
    cost_fn:    batched (obs, act, next_obs) -> cost.
    obs:        [obs_dim] current observation.
    model_state: forward-model state synced to reality.
    """
    if model_params is not None:
        predict_fn = partial(predict_fn, model_params)
    mark_step(pstate.mean.device)
    if cfg.cem_loop == "scan":
        return _plan_step_scan(cfg, predict_fn, cost_fn, pstate, obs, model_state)
    mean, std = pstate.mean, pstate.std
    gen = pstate.generator
    have_elites = pstate.have_elites
    elite_actions, elite_costs = pstate.elite_actions, pstate.elite_costs
    elite_last_obs = pstate.elite_last_obs
    device = mean.device

    E = cfg.elites_kept
    last_iter = cfg.opt_iterations - 1
    best_action_seq = best_cost = best_last_obs = None

    for i, n_i in enumerate(cfg.population_schedule):
        with phase("plan.noise", device):
            fresh = sample_action_sequences(cfg, gen, mean, std, n_i)
            if cfg.use_mean_actions and i == last_iter:
                fresh[0] = mean

            # -- assemble simulation set ---------------------------------
            if i == 0 and cfg.shift_elites_over_time and E > 0:
                # elites' actions shifted one step + fresh last action;
                # masked out until elites exist
                last_step = sample_action_sequences(cfg, gen, mean, std, E)[:, -1:, :]
                shifted = torch.cat([elite_actions[:E, 1:, :], last_step], dim=1)
                sim_actions = torch.cat([fresh, shifted], dim=0)
                sim_valid = torch.cat([torch.ones(n_i, dtype=torch.bool, device=device),
                                       torch.full((E,), have_elites, device=device)])
            else:
                sim_actions = fresh
                sim_valid = torch.ones(n_i, dtype=torch.bool, device=device)

        # -- simulate ------------------------------------------------------
        with phase("plan.rollout", device):
            traj = rollout_open_loop(predict_fn, model_state, obs, sim_actions)

        with phase("plan.select", device):
            sim_costs = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                        cfg.use_env_reward_as_cost)
            sim_last_obs = traj.next_observations[-1]  # [p, obs_dim]

            # -- candidates: fresh(+shifted) plus kept elites (cost reuse) -
            if i > 0 and cfg.keep_previous_elites and E > 0:
                cand_actions = torch.cat([sim_actions, elite_actions[:E]], dim=0)
                cand_costs = torch.cat([sim_costs, elite_costs[:E]], dim=0)
                cand_last_obs = torch.cat([sim_last_obs, elite_last_obs[:E]], dim=0)
                cand_valid = torch.cat([sim_valid,
                                        torch.ones(E, dtype=torch.bool, device=device)])
            else:
                cand_actions, cand_costs = sim_actions, sim_costs
                cand_last_obs, cand_valid = sim_last_obs, sim_valid

            # invalid rows AND non-finite costs rank last
            cand_costs = torch.where(cand_valid & torch.isfinite(cand_costs),
                                     cand_costs, float("inf"))

            best_action_seq, best_cost, best_last_obs = best_candidate(
                cand_actions, cand_costs, cand_last_obs)

            mean, std, elite_actions, elite_costs, elite_last_obs = _refit(
                cfg, mean, std, cand_actions, cand_costs, cand_last_obs)
        have_elites = True

    # execute the best trajectory's FIRST action, not the mean
    executed = best_action_seq[0]
    # shift mean one step, preserving the last entry; reset std
    mean = torch.cat([mean[1:], mean[-1:]], dim=0)
    std = init_std(cfg, device)

    new_state = ICemState(
        mean=mean, std=std,
        elite_actions=elite_actions, elite_costs=elite_costs,
        elite_last_obs=elite_last_obs, have_elites=have_elites, generator=gen,
    )
    return PlanResult(
        action=executed, state=new_state, expected_cost=best_cost,
        best_actions=best_action_seq, best_last_obs=best_last_obs,
    )


def _plan_step_scan(cfg: ICemConfig, predict_fn, cost_fn, pstate: ICemState,
                    obs, model_state, model_params=None) -> PlanResult:
    """``plan_step`` with every CEM iteration at one population, n_0 fresh
    rows plus E tail rows (``cfg.cem_loop == "scan"``).

    The JAX package runs this loop as one ``lax.scan``; here it is a Python
    loop with the same semantics:

    - every iteration samples n_0 fresh rows; rows >= n_i are invalid
      (ranked last, so they never become the executed best or an elite),
    - the E tail rows hold the shifted elites at i = 0 (re-simulated) and
      the kept elites at i > 0; kept elites are re-simulated too but keep
      their stored costs and last observations,
    - the tail is valid only once elites exist,
    - the mean replaces fresh row 0 in the last iteration,
    - the final iteration's best is executed.

    Noise is drawn in the JAX order: n_0 fresh rows, then E rows for the
    shift at every iteration (their last step is used at i = 0 only).
    ``model_params`` as in ``plan_step``.
    """
    if model_params is not None:
        predict_fn = partial(predict_fn, model_params)
    E = cfg.elites_kept
    schedule = cfg.population_schedule
    n0 = schedule[0]
    last_iter = cfg.opt_iterations - 1
    use_tail = E > 0 and (cfg.shift_elites_over_time or cfg.keep_previous_elites)

    mean, std = pstate.mean, pstate.std
    gen = pstate.generator
    have = pstate.have_elites
    e_a, e_c, e_o = pstate.elite_actions, pstate.elite_costs, pstate.elite_last_obs
    device = mean.device
    fresh_arange = torch.arange(n0, device=device)

    for i, n_i in enumerate(schedule):
        first = i == 0
        with phase("plan.noise", device):
            fresh = sample_action_sequences(cfg, gen, mean, std, n0)
            if cfg.use_mean_actions and i == last_iter:
                fresh[0] = mean
            fresh_valid = fresh_arange < n_i

            if use_tail:
                last_step = sample_action_sequences(cfg, gen, mean, std, E)[:, -1:, :]
                if first:
                    tail_actions = torch.cat([e_a[:E, 1:, :], last_step], dim=1)
                else:
                    tail_actions = e_a[:E]
                sim_actions = torch.cat([fresh, tail_actions], dim=0)
            else:
                sim_actions = fresh

        with phase("plan.rollout", device):
            traj = rollout_open_loop(predict_fn, model_state, obs, sim_actions)

        with phase("plan.select", device):
            sim_costs = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                        cfg.use_env_reward_as_cost)
            sim_last_obs = traj.next_observations[-1]

            if use_tail:
                # cost reuse at i > 0: stored elite costs, not the re-simulated ones
                tail_c = sim_costs[n0:] if first else e_c[:E]
                tail_o = sim_last_obs[n0:] if first else e_o[:E]
                cand_costs = torch.cat([sim_costs[:n0], tail_c])
                cand_last_obs = torch.cat([sim_last_obs[:n0], tail_o])
                tail_on = cfg.shift_elites_over_time if first else cfg.keep_previous_elites
                tail_valid = torch.full((E,), bool(tail_on and have), device=device)
                cand_valid = torch.cat([fresh_valid, tail_valid])
            else:
                cand_costs, cand_last_obs, cand_valid = sim_costs, sim_last_obs, fresh_valid
            cand_actions = sim_actions

            cand_costs = torch.where(cand_valid & torch.isfinite(cand_costs),
                                     cand_costs, float("inf"))
            best_action_seq, best_cost, best_last_obs = best_candidate(
                cand_actions, cand_costs, cand_last_obs)

            mean, std, e_a, e_c, e_o = _refit(cfg, mean, std, cand_actions, cand_costs,
                                              cand_last_obs)
        have = True

    executed = best_action_seq[0]
    mean = torch.cat([mean[1:], mean[-1:]], dim=0)
    std = init_std(cfg, device)
    new_state = ICemState(mean=mean, std=std, elite_actions=e_a, elite_costs=e_c,
                          elite_last_obs=e_o, have_elites=have, generator=gen)
    return PlanResult(action=executed, state=new_state, expected_cost=best_cost,
                      best_actions=best_action_seq, best_last_obs=best_last_obs)


def validate_sampler_params(asp: dict, allowed: tuple):
    """Reject unknown action_sampler_params keys: a typo would otherwise run
    the defaults silently."""
    unknown = set(asp) - set(allowed)
    if unknown:
        raise TypeError(f"unknown action_sampler_params {sorted(unknown)}; "
                        f"valid: {sorted(allowed)}")


_ICEM_SAMPLER_KEYS = (
    "alpha", "elites_size", "opt_iterations", "init_std", "use_mean_actions",
    "keep_previous_elites", "shift_elites_over_time", "fraction_elites_reused",
    "noise_beta",
)


class MpcICem(ModelConsistencyMixin, PlannerCheckpointMixin, ShardedPlannerMixin):
    """Controller with the reference API (beginning_of_rollout / get_action)
    around ``plan_step`` and its state.

    ``verbose``: check the synced model against the env state at every step
    (``check_model_consistency``; one host read a step). ``do_visualize_plan``
    (True / "last" or "all"): replay every chosen plan through the env and
    the model and report their divergence (``visualize_plan``). ``sharded``
    (False / True / "auto"): plan with the population sharded over a
    process group (``parallel/plan.py::resolve_group``).
    """

    needs_forward_model = True
    _shape_fields = ("horizon", "action_dim", "elites_size", "num_simulated_trajectories",
                     "fraction_elites_reused")

    def __init__(self, *, env, forward_model, action_sampler_params=None,
                 horizon=30, num_simulated_trajectories=40, factor_decrease_num=1.25,
                 cost_along_trajectory="sum", use_env_reward_as_cost=False,
                 verbose=False, do_visualize_plan=False, seed: Optional[int] = None,
                 sharded=False, cem_loop="auto", device=None, **kwargs):
        asp = dict(action_sampler_params or {})
        validate_sampler_params(asp, _ICEM_SAMPLER_KEYS)
        if cem_loop == "auto":
            # as in the JAX package: the spatial (3D) envs plan with the
            # scanned loop, the planar envs with the unrolled one
            from icem_torch.envs.spatial_base import SpatialEnv
            cem_loop = "scan" if isinstance(env, SpatialEnv) else "unrolled"
        self.env = env
        self.forward_model = forward_model
        self.device = resolve_device(device)
        self.cfg = ICemConfig(
            horizon=horizon,
            num_simulated_trajectories=num_simulated_trajectories,
            factor_decrease_num=factor_decrease_num,
            cost_along_trajectory=cost_along_trajectory,
            use_env_reward_as_cost=use_env_reward_as_cost,
            cem_loop=cem_loop,
            action_dim=env.action_space.dim,
            action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
            action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()),
            **{k: asp[k] for k in _ICEM_SAMPLER_KEYS if k in asp},
        )
        # multi-card planning is config-selectable (controller_params.sharded:
        # false | true | "auto"); the model's num_parallel caps the group
        from icem_torch.parallel.plan import resolve_group
        self._group = resolve_group(sharded, getattr(forward_model, "num_parallel", 0) or 0,
                                    self.device)
        if self._group is not None and self.cfg.cem_loop == "scan":
            print("MpcICem: cem_loop='scan' is single-device only; the sharded planner runs "
                  "its unrolled loop")
        self._announce_group()
        self._compiled_plan = None
        self.verbose = bool(verbose)
        self.do_visualize_plan = do_visualize_plan
        self._seed = seed
        self._pstate: Optional[ICemState] = None
        self._model_state = None
        self.was_reset = False
        self.last_expected_cost = None

    @property
    def model_evals_per_timestep(self):
        return self.cfg.model_evals_per_timestep

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _plan_impl(self):
        """(pstate, obs, model_state, model_params) -> PlanResult: ``plan_step``
        as a compiled step (``runtime/graphs.py``; one graph per shape and
        ``have_elites``), or ``plan_step_sharded`` over the controller's
        group, compiled the same way but for a gloo group on the card
        (``parallel/plan.py::ShardedPlan``)."""
        if self._compiled_plan is None:
            if self._group is None:
                self._compiled_plan = Compiled(
                    partial(plan_step, self.cfg, self._planner_fn(), self.env.cost_fn),
                    in_place=(3,), reads=self.forward_model.graph_reads, name="MpcICem.plan_step")
            else:
                from icem_torch.parallel.plan import ShardedPlan, plan_step_sharded
                self._compiled_plan = ShardedPlan(
                    plan_step_sharded, self.cfg, self._planner_fn(), self.env.cost_fn,
                    self._group, self.device, compiled=not self.plans_eagerly,
                    reads=self.forward_model.graph_reads, name="MpcICem.plan_step_sharded")
        return self._compiled_plan

    def beginning_of_rollout(self, *, observation, state=None, mode="train"):
        gen = Seeding.controller_generator(self._seed, "controller/icem", self.device)
        self._pstate = self.init_plan_state(int(np.shape(observation)[-1]), gen)
        self._model_state = self.forward_model.got_actual_observation_and_env_state(
            observation=self._as_tensor(observation),
            env_state=None if state is None else self._as_tensor(state),
            model_state=None)
        self.was_reset = True
        if self.verbose:
            print(f"iCEM using {self.cfg.model_evals_per_timestep} evaluations per step "
                  f"and {self.cfg.model_evals_per_timestep / self.cfg.horizon} "
                  f"trajectories per step")

    def visualize_plan(self, obs, env_state, result: PlanResult):
        """Replay the chosen plan (``result.best_actions``) from the real env
        state and report how far it lands from the model's prediction.

        - True / "last": the norm of the final observation's miss against
          ``result.best_last_obs``, printed when above 0.01; returned.
        - "all": the plan through both the env and the forward model; prints
          the first step where they differ by more than 0.01, with both
          observations, and returns the largest per-step difference.
        - "record": as "all", and writes the env replay's frames as the video
          ``plan_<counter:04d>`` under ``plan_video_dir`` (default "videos").

        Returns None without an env state. One host read, and one a frame
        when recording."""
        if env_state is None:
            return None
        mode = self.do_visualize_plan or "last"
        if mode is True:
            mode = "last"
        env_obs, env_states = [], []
        s = env_state
        for a in result.best_actions:
            s, o, _, _ = self.env.step(s, a)
            env_obs.append(o)
            env_states.append(s)
        env_obs = torch.stack(env_obs)
        if mode == "last":
            div = float(torch.linalg.vector_norm(env_obs[-1] - result.best_last_obs))
            if div > 0.01:
                print(f"plan divergence at horizon end: |env - model| = {div:.5f}")
            return div

        model_obs = []
        ms, ob = self._model_state, obs
        for a in result.best_actions:
            ms, ob, _ = self.forward_model.predict_fn(batch_tree(ms), ob[None], a[None])
            ms, ob = unbatch_tree(ms), ob[0]
            model_obs.append(ob)
        model_obs = torch.stack(model_obs).cpu().numpy()
        env_obs = env_obs.cpu().numpy()
        per_step = np.linalg.norm(env_obs - model_obs, axis=-1)
        bad = np.nonzero(per_step > 0.01)[0]
        if bad.size:
            i = int(bad[0])
            print(f"simulation for visualization does not match mental model at {i}: ")
            print("orig: ", model_obs[i])
            print("simu: ", env_obs[i])

        if mode == "record":
            self._plan_video_counter = getattr(self, "_plan_video_counter", 0) + 1
            rec = VideoRecorder(getattr(self, "plan_video_dir", "videos"),
                                f"plan_{self._plan_video_counter:04d}", fps=self.env.get_fps())
            for st in env_states:
                frame = self.env.render_frame(st)
                if frame is not None:
                    rec.append(frame)
            path = rec.close()
            if path:
                print(f"recorded plan replay: {path}")
        return float(per_step.max()) if len(per_step) else 0.0

    def get_action(self, obs, state=None, mode="train"):
        if not self.was_reset:
            raise AttributeError("beginning_of_rollout() needs to be called before")
        with span("icem.get_action"):
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
            if self.do_visualize_plan:
                self.visualize_plan(obs, state, result)
            self._after_action(obs, result.action)
            with span("icem.readback.action"):
                action = result.action.cpu().numpy()
            return action

    def end_of_rollout(self, total_time, total_return, mode):
        pass

    # -- functional interface for device-side episode loops ------------------
    def init_plan_state(self, obs_dim: int, generator: torch.Generator) -> ICemState:
        """A fresh planner state on ``generator``, with the rank streams of
        the sharded planner where the controller has a group."""
        pstate = init_state(self.cfg, int(obs_dim), generator)
        if self._group is None:
            return pstate
        from icem_torch.parallel.plan import init_rank_stream
        return pstate._replace(rank_stream=init_rank_stream(generator))

    def train(self, buffer):
        return {}
