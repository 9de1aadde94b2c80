"""Multi-card iCEM: the population sharded over a torch.distributed group.

Counterpart of ``icem_tpu/parallel/plan.py``. Where the JAX package runs a
``shard_map`` over a device mesh with one "pop" axis, this one runs the same
program on every rank of a process group (one rank per card, PyTorch's idiom
for a mesh axis):

- every rank samples ITS OWN population shard from its own random stream
  (``RankStream``: fixed by the planner's seed and the rank, the analogue of
  ``fold_in(key, axis_index)``), so the result at W ranks is a function of
  the seed and W only,
- rollouts and per-trajectory costs are local (on the card, kernel B1 or B2
  over the rank's rows); the shifted elites of iteration 0 are sliced across
  the ranks and simulated inside each rank's batch,
- elite selection is a LOCAL top-k followed by ONE ``all_gather`` of a
  packed (action sequence | cost | final obs) buffer, k_local * (h*d + 1 +
  obs_dim) floats per rank per CEM iteration, the only collective; then a
  replicated global selection. The global argmin is inside some rank's local
  top-k, so execute-best is exact,
- elite memory and the distribution refit stay replicated (tiny state).

Fresh-sample counts are rounded UP to a multiple of the group size, so the
sharded planner samples at least as many trajectories as the schedule.

The controllers call a plan step through ``ShardedPlan``: the rank streams
are seeded on the host before each call and passed in as generators, and
the step itself is a compiled step (``runtime/graphs.py``), on the card a
CUDA graph with the NCCL gather inside, as ``jax.jit`` compiles the JAX
package's. A gloo group on the card plans eagerly: its gather goes through
the host.
"""

from __future__ import annotations

import datetime
from functools import partial
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from icem_torch.controllers.icem import (ICemConfig, ICemState, PlanResult, _refit,
                                        best_candidate, init_std, sample_action_sequences,
                                        top_k_ascending)
from icem_torch.device import indexed, resolve_device
from icem_torch.models.base import rollout_open_loop, trajectory_cost
from icem_torch.runtime.graphs import Compiled

# how long a rank of a local group waits in a collective
_LOCAL_TIMEOUT = datetime.timedelta(minutes=5)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PopGroup(NamedTuple):
    """The ranks one sharded plan spans (a JAX mesh's "pop" axis)."""

    pg: Any       # the torch.distributed group; None: the default group
    rank: int     # this process's index in the group
    size: int     # W, the number of ranks
    backend: str  # "nccl" (card tensors) or "gloo" (host tensors)


class RankStream(NamedTuple):
    """The sharded planner's per-rank random streams. At plan step ``step``
    and CEM iteration i, rank r draws its shard from a generator seeded by
    (seed, step, i, r): host integers, so deriving a stream makes the host
    wait for nothing. Replicated on every rank, so rank 0's checkpoint
    resumes every rank."""

    seed: int
    step: int


def init_rank_stream(generator: torch.Generator) -> RankStream:
    """The rank streams of a planner whose replicated stream is
    ``generator``, fresh from its seed."""
    return RankStream(seed=int(generator.initial_seed()), step=0)


def rank_generator(stream: RankStream, rank: int, iteration: int, device) -> torch.Generator:
    """Rank ``rank``'s generator for CEM iteration ``iteration`` of the plan
    step ``stream.step``, on ``device``."""
    state = np.random.SeedSequence([stream.seed, stream.step, iteration, rank]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def rank_generators(stream: RankStream, rank: int, n_iterations: int, device) -> tuple:
    """The host prologue of a sharded plan step: ``rank_generator`` for every
    CEM iteration of the plan step ``stream.step``. Seeding sets host
    integers only, so the host waits for nothing."""
    return tuple(rank_generator(stream, rank, i, device) for i in range(n_iterations))


def _stream_generators(stream, rank: int, n_iterations: int, device) -> tuple:
    """This rank's generator for each CEM iteration: ``stream`` itself where
    the caller seeded them (``ShardedPlan``), else seeded here from it."""
    if isinstance(stream, RankStream):
        return rank_generators(stream, rank, n_iterations, device)
    return stream


def _advanced(stream):
    """The stream of the next plan step; a caller's generators are handed
    back as they are, for the caller to advance (``ShardedPlan.join``)."""
    return stream._replace(step=stream.step + 1) if isinstance(stream, RankStream) else stream


# one-rank groups made without a process group, one per backend and device
_LOCAL_GROUPS: dict = {}


def _local_group(device) -> PopGroup:
    """A one-rank group of this process alone, rendezvoused in memory
    (``HashStore``): NCCL on the card, gloo on the CPU. It leaves the
    default process group untouched."""
    device = indexed(resolve_device(device))
    key = (device.type, device.index)
    if key not in _LOCAL_GROUPS:
        store = dist.HashStore()
        if device.type == "cuda":
            with torch.cuda.device(device):
                _LOCAL_GROUPS[key] = PopGroup(dist.ProcessGroupNCCL(store, 0, 1), 0, 1, "nccl")
        else:
            _LOCAL_GROUPS[key] = PopGroup(dist.ProcessGroupGloo(store, 0, 1, _LOCAL_TIMEOUT),
                                          0, 1, "gloo")
    return _LOCAL_GROUPS[key]


def close_local_groups():
    """Shut down the one-rank groups ``resolve_group`` made."""
    for group in _LOCAL_GROUPS.values():
        if hasattr(group.pg, "shutdown"):
            group.pg.shutdown()
    _LOCAL_GROUPS.clear()


# groups of the first n ranks, one per n: every rank makes them in one order
_CAPPED_GROUPS: dict = {}


def make_pop_group(ranks=None, device=None) -> Optional[PopGroup]:
    """The group over ``ranks`` (default: every rank) of the default
    process group; where none is up, the one-rank group of this process on
    ``device`` (the card unless told otherwise). A group of fewer ranks than
    the world is made with ``dist.new_group``, which every rank must call; a
    rank outside it gets None."""
    if not dist.is_initialized():
        if ranks is not None and list(ranks) != [0]:
            raise ValueError(f"no process group is up: ranks {list(ranks)} do not exist")
        return _local_group(device)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(ranks)
    backend = dist.get_backend()
    if len(ranks) == world:
        return PopGroup(None, dist.get_rank(), world, backend)
    key = tuple(ranks)
    if key not in _CAPPED_GROUPS:
        _CAPPED_GROUPS[key] = dist.new_group(ranks)
    pg = _CAPPED_GROUPS[key]
    if dist.get_rank() not in ranks:
        return None
    return PopGroup(pg, dist.get_rank(pg), len(ranks), backend)


def resolve_group(sharded, num_parallel: int = 0, device=None) -> Optional[PopGroup]:
    """Decide the planning group from the config-level ``sharded`` option
    (``resolve_mesh`` in the JAX package).

    - ``False``: None, planning on this process's device alone.
    - ``True``: the group of every rank, capped by ``num_parallel``; where no
      process group is up, a one-rank group of this process (the JAX mesh
      over one device still runs ``shard_map``).
    - ``"auto"``: a group iff the capped world has more than one rank.

    ``num_parallel`` > 0 (the ParallelGroundTruthModel hint) caps the group
    at the first ``num_parallel`` ranks. Every rank must call this with the
    same arguments, since a capped group is made collectively; a rank
    outside the cap gets None and plans unsharded on its own card, a replica
    of the same experiment with no part in the sharded plan.
    """
    if not sharded:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    width = world
    if num_parallel and num_parallel > 0:
        width = max(1, min(int(num_parallel), world))
    if sharded == "auto" and width <= 1:
        return None
    return make_pop_group(None if width == world else range(width), device)


def gather_rows(group: PopGroup, packed: torch.Tensor) -> torch.Tensor:
    """Every rank's ``packed`` rows, in rank order: the planner's one
    collective per CEM iteration (``dist.all_gather``). NCCL gathers card
    tensors; gloo gathers host tensors, so card rows under gloo go to the
    host and back, one copy each way."""
    if group.backend == "nccl" and not packed.is_cuda:
        raise ValueError("an NCCL group gathers card tensors; plan on the card or use gloo")
    rows = packed.cpu() if group.backend == "gloo" else packed
    out = [torch.empty_like(rows) for _ in range(group.size)]
    dist.all_gather(out, rows, group=group.pg)
    return torch.cat(out).to(packed.device)


def _pack(actions, costs, last_obs, k: int):
    """The ``k`` lowest-cost rows as one [k, h*d + 1 + obs_dim] block."""
    order = top_k_ascending(costs, k)
    return torch.cat([actions[order].reshape(k, -1), costs[order][:, None], last_obs[order]],
                     dim=1)


def _unpack(rows, h: int, d: int):
    return rows[:, : h * d].reshape(-1, h, d), rows[:, h * d], rows[:, h * d + 1:]


def plan_step_sharded(cfg: ICemConfig, predict_fn, cost_fn, group: PopGroup,
                      pstate: ICemState, obs, model_state, model_params=None) -> PlanResult:
    """One iCEM planning step with the population sharded over ``group``.

    The algorithm of ``controllers.icem.plan_step`` (the unrolled loop,
    whatever ``cfg.cem_loop`` says); only the population's layout differs.
    ``pstate.rank_stream`` holds the rank streams (``init_rank_stream``), or
    this rank's generator for each CEM iteration seeded from them
    (``rank_generators``; ``ShardedPlan`` hands them in so that no step
    count reaches a compiled step's key); ``model_params`` as in
    ``plan_step``, replicated. Returns a PlanResult, the same contract as
    ``plan_step``, its state's stream one step on (generators come back as
    they came in).
    """
    if model_params is not None:
        predict_fn = partial(predict_fn, model_params)
    W, rank = group.size, group.rank
    K, E = cfg.num_elites, cfg.elites_kept
    last_iter = cfg.opt_iterations - 1
    h, d = cfg.horizon, cfg.action_dim

    mean, std, gen = pstate.mean, pstate.std, pstate.generator
    have_elites = pstate.have_elites
    elite_actions, elite_costs = pstate.elite_actions, pstate.elite_costs
    elite_last_obs = pstate.elite_last_obs
    stream = pstate.rank_stream
    device = mean.device
    rank_gens = _stream_generators(stream, rank, cfg.opt_iterations, device)

    # shifted elites at i == 0 are sharded like the fresh samples: each rank
    # simulates its e_local-row slice in its own batch, padding rows invalid
    e_local = _cdiv(E, W) if (cfg.shift_elites_over_time and E > 0) else 0
    best_action_seq = best_cost = best_last_obs = None

    for i, n_i in enumerate(cfg.population_schedule):
        n_local = _cdiv(n_i, W)
        with_shifted = e_local > 0 and i == 0
        if with_shifted:
            # elites' actions shifted one step + a fresh last action, drawn
            # from the replicated stream, padded to the group's width
            last_step = sample_action_sequences(cfg, gen, mean, std, E)[:, -1:, :]
            shifted = torch.cat([elite_actions[:E, 1:, :], last_step], dim=1)
            shifted = torch.cat([shifted, torch.zeros((e_local * W - E, h, d), device=device)])
            valid_all = (torch.arange(e_local * W, device=device) < E) & have_elites

        sim = sample_action_sequences(cfg, rank_gens[i], mean, std, n_local)
        if cfg.use_mean_actions and i == last_iter and rank == 0:
            sim[0] = mean  # the mean as a candidate, on rank 0 only
        valid = torch.ones(n_local, dtype=torch.bool, device=device)
        if with_shifted:
            mine = slice(rank * e_local, (rank + 1) * e_local)
            sim = torch.cat([sim, shifted[mine]])
            valid = torch.cat([valid, valid_all[mine]])

        traj = rollout_open_loop(predict_fn, model_state, obs, sim)
        costs = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                cfg.use_env_reward_as_cost)
        costs = torch.where(valid & torch.isfinite(costs), costs, float("inf"))
        packed = _pack(sim, costs, traj.next_observations[-1], min(K, sim.shape[0]))
        cand_a, cand_c, cand_o = _unpack(gather_rows(group, packed), h, d)

        if i > 0 and cfg.keep_previous_elites and E > 0:
            # kept elites re-enter with their STORED costs, not re-simulated
            cand_a = torch.cat([cand_a, elite_actions[:E]])
            cand_c = torch.cat([cand_c, elite_costs[:E]])
            cand_o = torch.cat([cand_o, elite_last_obs[:E]])
        cand_c = torch.where(torch.isfinite(cand_c), cand_c, float("inf"))

        best_action_seq, best_cost, best_last_obs = best_candidate(cand_a, cand_c, cand_o)
        mean, std, elite_actions, elite_costs, elite_last_obs = _refit(
            cfg, mean, std, cand_a, cand_c, cand_o)
        have_elites = True

    executed = best_action_seq[0]
    mean = torch.cat([mean[1:], mean[-1:]], dim=0)
    std = init_std(cfg, device)
    new_state = ICemState(mean=mean, std=std, elite_actions=elite_actions,
                          elite_costs=elite_costs, elite_last_obs=elite_last_obs,
                          have_elites=have_elites, generator=gen,
                          rank_stream=_advanced(stream))
    return PlanResult(action=executed, state=new_state, expected_cost=best_cost,
                      best_actions=best_action_seq, best_last_obs=best_last_obs)


def cem_plan_step_sharded(cfg, predict_fn, cost_fn, group: PopGroup, pstate, obs,
                          model_state, model_params=None):
    """Vanilla-CEM planning step (``controllers.cem_std.plan_step``) with
    the population sharded over ``group``.

    The layout of ``plan_step_sharded``: every rank draws and simulates its
    own truncated-normal shard, selects a local top-k, and one gather feeds
    the replicated refit. k_local = min(num_elites, shard) per rank, so the
    elites and the executed best action are exact. ``pstate.rank_stream``
    as in ``plan_step_sharded``. Returns a CemPlanResult.
    """
    from icem_torch.controllers.cem_std import (CemPlanResult, CemStdState, _bounds,
                                               _init_std, truncated_normal, truncated_uniform)

    if model_params is not None:
        predict_fn = partial(predict_fn, model_params)
    W, rank = group.size, group.rank
    K = cfg.num_elites
    h, d = cfg.horizon, cfg.action_dim
    mean, std, stream = pstate.mean, pstate.std, pstate.rank_stream
    low, high = cfg.bounds(mean.device)
    n_local = _cdiv(cfg.num_simulated_trajectories, W)
    rank_gens = _stream_generators(stream, rank, cfg.opt_iterations, mean.device)
    best_actions = best_cost = best_last_obs = None

    for i in range(cfg.opt_iterations):
        # the Levine std clamp updates the replicated std, as in plan_step
        lower, upper, std = _bounds(cfg, mean, std, low, high)
        u = truncated_uniform(rank_gens[i], (n_local, h, d))
        actions = truncated_normal(u, lower, upper, mean, std)
        traj = rollout_open_loop(predict_fn, model_state, obs, actions)
        costs = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                cfg.use_env_reward_as_cost)
        packed = _pack(actions, costs, traj.next_observations[-1], min(K, n_local))
        cand_a, cand_c, cand_o = _unpack(gather_rows(group, packed), h, d)
        cand_c = torch.where(torch.isfinite(cand_c), cand_c, float("inf"))

        best_actions, best_cost, best_last_obs = best_candidate(cand_a, cand_c, cand_o)
        elites = cand_a[top_k_ascending(cand_c, K)]
        mean = (1 - cfg.alpha) * torch.mean(elites, dim=0) + cfg.alpha * mean
        std = (1 - cfg.alpha) * torch.std(elites, dim=0, correction=0) + cfg.alpha * std

    executed = best_actions[0] if cfg.execute_best_elite else mean[0]
    if cfg.shift_means:
        last = torch.zeros_like(mean[-1:]) if cfg.bounds_like_levine else mean[-1:]
        mean = torch.cat([mean[1:], last], dim=0)
    else:
        mean = torch.zeros_like(mean)
    std = _init_std(cfg, low, high)
    return CemPlanResult(action=executed,
                         state=CemStdState(mean, std, pstate.generator, _advanced(stream)),
                         expected_cost=best_cost, best_actions=best_actions,
                         best_last_obs=best_last_obs)


class ShardedPlan:
    """A sharded plan step as a controller calls it, (pstate, obs,
    model_state, model_params) -> result, with the rank streams seeded on
    the host around ``body``.

    ``body`` is ``step_fn`` (``plan_step_sharded`` or
    ``cem_plan_step_sharded``) over ``group``: a compiled step
    (``runtime/graphs.py``; ``in_place=(3,)`` for a learned model's weights,
    ``reads`` as for the unsharded plan step), or, with ``compiled`` False
    (a gloo group on the card, whose gather goes through the host), the
    plain function. ``split`` puts this rank's generators, seeded from the
    state's ``RankStream``, in its place, so no integer that changes from
    step to step reaches the compiled step's key; ``join`` puts the stream
    back one step on.
    """

    def __init__(self, step_fn, cfg, predict_fn, cost_fn, group: PopGroup, device, *,
                 compiled: bool, reads=None, name: Optional[str] = None):
        body = partial(step_fn, cfg, predict_fn, cost_fn, group)
        self.body = Compiled(body, in_place=(3,), reads=reads, name=name) if compiled else body
        self.rank, self.n_iterations, self.device = group.rank, cfg.opt_iterations, device

    def split(self, pstate):
        """``pstate`` with this rank's generators for its step as its stream."""
        return pstate._replace(rank_stream=rank_generators(
            pstate.rank_stream, self.rank, self.n_iterations, self.device))

    @staticmethod
    def join(state, stream: RankStream):
        """``state`` with ``stream`` one step on."""
        return state._replace(rank_stream=stream._replace(step=stream.step + 1))

    def __call__(self, pstate, obs, model_state, model_params=None):
        if not isinstance(pstate.rank_stream, RankStream):
            # split already, by ``around``: inside the device episode's step
            return self.body(pstate, obs, model_state, model_params)
        res = self.body(self.split(pstate), obs, model_state, model_params)
        return res._replace(state=self.join(res.state, pstate.rank_stream))

    def around(self, step):
        """``step``, (pstate, *args) -> (pstate', *rest) with a split
        ``pstate``, as the same over a whole ``pstate``: the device episode's
        control step. ``.step`` is ``step``."""

        def stepped(pstate, *args):
            new, *rest = step(self.split(pstate), *args)
            return (self.join(new, pstate.rank_stream), *rest)

        stepped.step = step
        return stepped
