"""icem_torch/parallel: the sharded planners over torch.distributed, on the CPU.

- Ranks are separate processes in a gloo group rendezvoused through a
  ``FileStore`` under the test's temporary directory (no port to collide
  with), each with a timeout, so a hung rank fails a test.
- At 2 and 3 ranks (sizes that divide neither the populations 47 / 37 / 29
  nor the 5 kept elites), ``plan_step_sharded`` and ``cem_plan_step_sharded``
  equal bit for bit a one-process emulation of their spec: every rank's
  shard regenerated from its rank stream, every rank's batch rolled out as
  that rank rolled it out, then a global selection over the union of the
  candidates, with no local top-k and no collective. The ranks equal each
  other bit for bit.
- At 1 and 2 ranks the port's sharded planners match the JAX package's
  ``plan_step_sharded`` / ``cem_plan_step_sharded`` on a CPU mesh of as many
  devices, on injected noise (the JAX sampler picks its block of the noise
  with ``axis_index``), at atol 1e-4 / rtol 1e-5.
- The controllers plan sharded, a sharded checkpoint resumes bit for bit,
  the bootstrap starts a group from the launch line, and the driver's
  ``"auto"`` default shards at two ranks.
"""

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

import icem_tpu.controllers.cem_std as jcs
import icem_tpu.controllers.icem as jic
import icem_tpu.parallel.plan as jplan
from icem_torch.controllers import cem_std as tcs
from icem_torch.controllers import icem as tic
from icem_torch.controllers.icem import MpcICem
from icem_torch.envs import env_from_string
from icem_torch.envs.classic import ContinuousPendulum, PointMass
from icem_torch.models.base import rollout_open_loop, trajectory_cost
from icem_torch.models.ground_truth import GroundTruthModel
from icem_torch.parallel import multihost
from icem_torch.parallel import plan as tplan
from icem_torch.runtime import graphs
from icem_tpu.envs.classic import ContinuousPendulum as JaxPendulum
from icem_tpu.envs.classic import PointMass as JaxPointMass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # seconds a spawned run may take, start-up included
TOL = dict(atol=1e-4, rtol=1e-5)  # tests/test_torch_icem.py's

CHEETAH = ("HalfCheetah", dict(exclude_current_positions_from_observation=True,
                               penalise_flipping=True))
# populations 47 / 37 / 29 and 5 kept elites: neither 2 nor 3 ranks divide them
ICEM_CFG = dict(num_simulated_trajectories=47, elites_size=10, fraction_elites_reused=0.5)
CEM_CFG = dict(num_simulated_trajectories=47, elites_size=10)
# name: (env, env kwargs, planner, config, planner seed, start-state seed)
CASES = {
    "icem_pendulum": ("ContinuousPendulum", {}, "icem",
                      dict(ICEM_CFG, horizon=8, noise_beta=2.0), 5, 0),
    "cem_pendulum": ("ContinuousPendulum", {}, "cem", dict(CEM_CFG, horizon=8), 6, 1),
    "icem_cheetah": (*CHEETAH, "icem", dict(ICEM_CFG, horizon=5, noise_beta=0.25), 7, 2),
    "cem_cheetah": (*CHEETAH, "cem", dict(CEM_CFG, horizon=5, bounds_like_levine=True), 8, 3),
}
PLAN_STEPS = 2
# the injected-noise cases held against the JAX package (fixed observation)
INJECTED = {
    "icem_pendulum": ("icem", dict(ICEM_CFG, horizon=8), np.array([np.pi * 0.9, 0.3])),
    "cem_point_mass": ("cem", dict(CEM_CFG, horizon=8), np.array([0.25, -0.3, 0.1, 0.0])),
}


def _config(planner, env, cfg):
    kw = dict(cfg, action_dim=env.action_space.dim,
              action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
              action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()))
    return tic.ICemConfig(**kw) if planner == "icem" else tcs.CemStdConfig(**kw)


def _port_state(planner, cfg, obs_dim, seed):
    gen = torch.Generator().manual_seed(seed)
    pstate = (tic.init_state(cfg, obs_dim, gen) if planner == "icem"
              else tcs.init_state(cfg, gen))
    return pstate._replace(rank_stream=tplan.init_rank_stream(gen))


def _record(res):
    """The fields of a plan result compared across runs, as numpy arrays."""
    st = res.state
    out = dict(action=res.action, expected_cost=res.expected_cost,
               best_actions=res.best_actions, best_last_obs=res.best_last_obs,
               mean=st.mean, std=st.std)
    if hasattr(st, "elite_actions"):
        out.update(elite_actions=st.elite_actions, elite_costs=st.elite_costs,
                   elite_last_obs=st.elite_last_obs)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the spawned ranks

_RANK_PROG = r"""
import datetime, json, os, sys
sys.path.insert(0, os.environ["ICEM_REPO"])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, mode, store, spec_path, out_path = sys.argv[1:7]
rank, world = int(rank), int(world)
spec = json.load(open(spec_path))
gathers = []
_all_gather = dist.all_gather
def counting_all_gather(*args, **kwargs):
    gathers.append(1)
    return _all_gather(*args, **kwargs)
dist.all_gather = counting_all_gather
from icem_torch.controllers import cem_std as tcs, icem as tic
from icem_torch.envs import env_from_string
from icem_torch.models.ground_truth import GroundTruthModel
from icem_torch.parallel import plan
out = {"gathers": {}}

def record(res):
    st = res.state
    r = dict(action=res.action, expected_cost=res.expected_cost,
             best_actions=res.best_actions, best_last_obs=res.best_last_obs,
             mean=st.mean, std=st.std)
    if hasattr(st, "elite_actions"):
        r.update(elite_actions=st.elite_actions, elite_costs=st.elite_costs,
                 elite_last_obs=st.elite_last_obs)
    return {k: v.detach().cpu().numpy() for k, v in r.items()}

def config(planner, env, cfg):
    kw = dict(cfg, action_dim=env.action_space.dim,
              action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
              action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()))
    return tic.ICemConfig(**kw) if planner == "icem" else tcs.CemStdConfig(**kw)

def state(planner, cfg, obs_dim, seed):
    gen = torch.Generator().manual_seed(seed)
    ps = tic.init_state(cfg, obs_dim, gen) if planner == "icem" else tcs.init_state(cfg, gen)
    return ps._replace(rank_stream=plan.init_rank_stream(gen))

if mode == "main":
    os.environ.update(ICEM_MULTIHOST="1", ICEM_COORDINATOR=store, ICEM_NUM_PROCESSES=str(world),
                      ICEM_PROCESS_ID=str(rank))
    sizes = []
    _gather_rows = plan.gather_rows
    def gather_rows(group, packed):
        sizes.append(group.size)
        return _gather_rows(group, packed)
    plan.gather_rows = gather_rows
    from icem_torch import main as tmain
    from icem_torch.parallel.multihost import process_zero
    info = tmain.main(["icem_torch.main", *spec["argv"], f"model_dir={spec['model_dir']}_{rank}",
                       "--device", "cpu"])
    from icem_torch.runtime.seeding import Seeding
    out.update(sizes=sizes, returns=info["train_mean_return"], zero=process_zero(),
               world=dist.get_world_size(), rank=dist.get_rank(), seed=Seeding.SEED)
    torch.save(out, out_path)
    dist.destroy_process_group()
    sys.exit(0)

dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
group = plan.resolve_group(True, device="cpu")
assert (group.rank, group.size) == (rank, world), group

def sharded(planner):
    return plan.plan_step_sharded if planner == "icem" else plan.cem_plan_step_sharded

# the sharded plans, two steps each, the env stepped by the executed action
for name, (env_name, env_kw, planner, cfg, seed, start) in spec["cases"].items():
    env = env_from_string(env_name, **env_kw)
    cfg = config(planner, env, cfg)
    predict = GroundTruthModel(env=env).predict_fn
    s = env.init_state(torch.Generator().manual_seed(start))
    ps = state(planner, cfg, env.obs_dim, seed)
    steps, before = [], len(gathers)
    for _ in range(spec["steps"]):
        res = sharded(planner)(cfg, predict, env.cost_fn, group, ps, env.observation(s), s)
        steps.append(record(res))
        ps = res.state
        s = env.step(s, res.action)[0]
    out[name] = steps
    out["gathers"][name] = len(gathers) - before

# the injected-noise plans held against the JAX package: rank r draws its
# block of each [world, n_local, h, d] array, the replicated draws are [E, h, d]
if spec.get("injected"):
    real_draws = plan.sample_action_sequences, tcs.truncated_uniform
    noise = np.load(spec["injected"]["noise"])
    for name, (planner, cfg, s0) in spec["injected"]["cases"].items():
        queue = iter(noise[f"{name}_{k}"] for k in range(len(noise.files))
                     if f"{name}_{k}" in noise)
        def fake_sample(cfg, generator, mean, std, num_traj):
            n = next(queue)
            n = n[rank] if n.ndim == 4 else n
            assert n.shape[0] == num_traj, (n.shape, num_traj)
            low, high = cfg.bounds(mean.device)
            return torch.clamp(torch.from_numpy(n) * std + mean, low, high)
        def fake_uniform(generator, shape):
            u = next(queue)[rank]
            assert tuple(u.shape) == tuple(shape), (u.shape, shape)
            return torch.from_numpy(u)
        plan.sample_action_sequences, tcs.truncated_uniform = fake_sample, fake_uniform
        from icem_torch.envs.classic import ContinuousPendulum, PointMass
        env = ContinuousPendulum() if name.endswith("pendulum") else PointMass(goal=(0.15, -0.1))
        cfg = config(planner, env, cfg)
        s = torch.tensor(s0, dtype=torch.float32)
        ps = state(planner, cfg, env.obs_dim, 0)
        steps = []
        for _ in range(spec["steps"]):
            res = sharded(planner)(cfg, GroundTruthModel(env=env).predict_fn, env.cost_fn, group,
                                   ps, env.observation(s), s)
            steps.append(record(res))
            ps = res.state
        out["injected_" + name] = steps
        assert next(queue, None) is None
    plan.sample_action_sequences, tcs.truncated_uniform = real_draws

if spec.get("semantics"):
    sem = {}
    sem["auto"] = plan.resolve_group("auto", device="cpu").size
    g = plan.resolve_group(True, num_parallel=1, device="cpu")
    sem["capped"] = None if g is None else (g.rank, g.size)
    sem["auto_capped"] = plan.resolve_group("auto", num_parallel=1, device="cpu")
    sem["false"] = plan.resolve_group(False, device="cpu")
    out["semantics"] = sem

if spec.get("controllers"):
    import pickle
    from icem_torch.controllers.icem import MpcICem
    env = env_from_string("ContinuousPendulum")
    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=15,
                   num_simulated_trajectories=32, sharded=True, seed=11, device="cpu",
                   action_sampler_params={"opt_iterations": 2, "noise_beta": 2.0})
    assert ctrl._group.size == world
    s = torch.tensor([np.pi * 0.9, 0.0])
    o = env.observation(s)
    ctrl.beginning_of_rollout(observation=o, state=s)
    rewards = []
    for t in range(60):
        if t == 30:
            path = spec["controllers"] + ".ctrl"
            if rank == 0:
                ctrl.save(path)
            dist.barrier()
            fresh = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=15,
                            num_simulated_trajectories=32, sharded=True, seed=99, device="cpu",
                            action_sampler_params={"opt_iterations": 2, "noise_beta": 2.0})
            fresh.load(path)
            a = ctrl.get_action(o, s)
            out["resumed"] = (a, fresh.get_action(o, s))
        else:
            a = ctrl.get_action(o, s)
        s, o, r, _ = env.step(s, torch.as_tensor(a))
        rewards.append(float(r))
    out["rewards"] = rewards

torch.save(out, out_path)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """A run of ``world`` rank processes; ``results()`` waits for them."""

    def __init__(self, tmp, tag, world, mode, spec, store=None):
        self.tmp, self.tag = tmp, tag
        spec_path = tmp / f"{tag}.json"
        spec_path.write_text(json.dumps(spec))
        store = store or str(tmp / f"{tag}.store")
        env = {k: v for k, v in os.environ.items() if not k.startswith("ICEM_")}
        env.update(ICEM_REPO=REPO, OMP_NUM_THREADS="1")
        self.outs = [tmp / f"{tag}_{r}.pt" for r in range(world)]
        self.logs = [open(tmp / f"{tag}_{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_PROG, str(r), str(world), mode, store, str(spec_path),
             str(self.outs[r])], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]
        self.start = datetime.datetime.now()

    def results(self):
        try:
            for p in self.procs:
                left = RANK_TIMEOUT - (datetime.datetime.now() - self.start).total_seconds()
                p.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        rcs = [p.returncode for p in self.procs]
        if rcs != [0] * len(rcs):
            logs = "\n".join((self.tmp / f"{self.tag}_{r}.log").read_text()[-3000:]
                             for r in range(len(rcs)))
            pytest.fail(f"{self.tag}: rank exit codes {rcs} (timeout {RANK_TIMEOUT} s)\n{logs}")
        return [torch.load(p, weights_only=False) for p in self.outs]


# ---------------------------------------------------------------------------
# the one-process emulation of the sharded planners' spec

def _cdiv(a, b):
    return -(-a // b)


def emulate_plan_step_sharded(cfg, predict_fn, cost_fn, W, pstate, obs, model_state):
    """plan_step_sharded's spec in one process: each rank's shard from its
    stream, each rank's batch rolled out alone, a direct global selection."""
    K, E = cfg.num_elites, cfg.elites_kept
    last_iter = cfg.opt_iterations - 1
    h, d = cfg.horizon, cfg.action_dim
    mean, std, gen = pstate.mean, pstate.std, pstate.generator
    have = pstate.have_elites
    e_a, e_c, e_o = pstate.elite_actions, pstate.elite_costs, pstate.elite_last_obs
    stream = pstate.rank_stream
    e_local = _cdiv(E, W) if (cfg.shift_elites_over_time and E > 0) else 0
    assert K >= 1
    for i, n_i in enumerate(cfg.population_schedule):
        n_local = _cdiv(n_i, W)
        if e_local and i == 0:
            last_step = tic.sample_action_sequences(cfg, gen, mean, std, E)[:, -1:, :]
            shifted = torch.cat([e_a[:E, 1:, :], last_step], dim=1)
        cand_a, cand_c, cand_o = [], [], []
        for r in range(W):
            sim = tic.sample_action_sequences(
                cfg, tplan.rank_generator(stream, r, i, "cpu"), mean, std, n_local)
            if cfg.use_mean_actions and i == last_iter and r == 0:
                sim[0] = mean
            valid = torch.ones(n_local, dtype=torch.bool)
            if e_local and i == 0:
                mine = torch.zeros((e_local, h, d))
                mine_valid = torch.zeros(e_local, dtype=torch.bool)
                for j in range(e_local):
                    if r * e_local + j < E:  # else a padding row, invalid
                        mine[j] = shifted[r * e_local + j]
                        mine_valid[j] = have
                sim = torch.cat([sim, mine])
                valid = torch.cat([valid, mine_valid])
            traj = rollout_open_loop(predict_fn, model_state, obs, sim)
            c = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                cfg.use_env_reward_as_cost)
            cand_a.append(sim)
            cand_c.append(torch.where(valid & torch.isfinite(c), c, float("inf")))
            cand_o.append(traj.next_observations[-1])
        if i > 0 and cfg.keep_previous_elites and E > 0:
            cand_a.append(e_a[:E])
            cand_c.append(e_c[:E])
            cand_o.append(e_o[:E])
        cand_a, cand_c, cand_o = torch.cat(cand_a), torch.cat(cand_c), torch.cat(cand_o)
        cand_c = torch.where(torch.isfinite(cand_c), cand_c, float("inf"))
        best_a, best_c, best_o = tic.best_candidate(cand_a, cand_c, cand_o)
        mean, std, e_a, e_c, e_o = tic._refit(cfg, mean, std, cand_a, cand_c, cand_o)
        have = True
    mean = torch.cat([mean[1:], mean[-1:]])
    state = tic.ICemState(mean=mean, std=tic.init_std(cfg, "cpu"), elite_actions=e_a,
                          elite_costs=e_c, elite_last_obs=e_o, have_elites=have, generator=gen,
                          rank_stream=stream._replace(step=stream.step + 1))
    return tic.PlanResult(action=best_a[0], state=state, expected_cost=best_c,
                          best_actions=best_a, best_last_obs=best_o)


def emulate_cem_plan_step_sharded(cfg, predict_fn, cost_fn, W, pstate, obs, model_state):
    """cem_plan_step_sharded's spec in one process (see above)."""
    mean, std, stream = pstate.mean, pstate.std, pstate.rank_stream
    low, high = cfg.bounds("cpu")
    n_local = _cdiv(cfg.num_simulated_trajectories, W)
    h, d = cfg.horizon, cfg.action_dim
    for i in range(cfg.opt_iterations):
        lower, upper, std = tcs._bounds(cfg, mean, std, low, high)
        cand_a, cand_c, cand_o = [], [], []
        for r in range(W):
            u = tcs.truncated_uniform(tplan.rank_generator(stream, r, i, "cpu"), (n_local, h, d))
            a = tcs.truncated_normal(u, lower, upper, mean, std)
            traj = rollout_open_loop(predict_fn, model_state, obs, a)
            cand_a.append(a)
            cand_c.append(trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                          cfg.use_env_reward_as_cost))
            cand_o.append(traj.next_observations[-1])
        cand_a, cand_c, cand_o = torch.cat(cand_a), torch.cat(cand_c), torch.cat(cand_o)
        cand_c = torch.where(torch.isfinite(cand_c), cand_c, float("inf"))
        best_a, best_c, best_o = tic.best_candidate(cand_a, cand_c, cand_o)
        elites = cand_a[tic.top_k_ascending(cand_c, cfg.num_elites)]
        mean = (1 - cfg.alpha) * torch.mean(elites, dim=0) + cfg.alpha * mean
        std = (1 - cfg.alpha) * torch.std(elites, dim=0, correction=0) + cfg.alpha * std
    executed = best_a[0] if cfg.execute_best_elite else mean[0]
    last = torch.zeros_like(mean[-1:]) if cfg.bounds_like_levine else mean[-1:]
    mean = torch.cat([mean[1:], last]) if cfg.shift_means else torch.zeros_like(mean)
    state = tcs.CemStdState(mean, tcs._init_std(cfg, low, high), pstate.generator,
                            stream._replace(step=stream.step + 1))
    return tcs.CemPlanResult(action=executed, state=state, expected_cost=best_c,
                             best_actions=best_a, best_last_obs=best_o)


def _emulate_case(name, W):
    env_name, env_kw, planner, cfg, seed, start = CASES[name]
    env = env_from_string(env_name, **env_kw)
    cfg = _config(planner, env, cfg)
    predict = GroundTruthModel(env=env).predict_fn
    emulate = emulate_plan_step_sharded if planner == "icem" else emulate_cem_plan_step_sharded
    s = env.init_state(torch.Generator().manual_seed(start))
    ps = _port_state(planner, cfg, env.obs_dim, seed)
    steps = []
    for _ in range(PLAN_STEPS):
        res = emulate(cfg, predict, env.cost_fn, W, ps, env.observation(s), s)
        steps.append(_record(res))
        ps = res.state
        s = env.step(s, res.action)[0]
    return steps


# ---------------------------------------------------------------------------
# injected noise for the JAX comparison

def _injected_envs(name):
    if name.endswith("pendulum"):
        return ContinuousPendulum(), JaxPendulum()
    return PointMass(goal=(0.15, -0.1)), JaxPointMass(goal=(0.15, -0.1))


def _injected_noise(W):
    """Per case, the noise in draw order over the plan steps: the
    replicated [E, h, d] draw of the shifted elites, then a [W, n_local, h,
    d] array per iteration (normals for iCEM, uniforms for vanilla CEM)."""
    rng = np.random.default_rng(100 + W)
    noise = {}
    for name, (planner, cfg, _) in INJECTED.items():
        env = _injected_envs(name)[0]
        c = _config(planner, env, cfg)
        h, d = c.horizon, c.action_dim
        arrays = []
        for _ in range(PLAN_STEPS):
            if planner == "icem":
                for i, n_i in enumerate(c.population_schedule):
                    if i == 0 and c.shift_elites_over_time and c.elites_kept > 0:
                        arrays.append(rng.standard_normal((c.elites_kept, h, d)))
                    arrays.append(rng.standard_normal((W, _cdiv(n_i, W), h, d)))
            else:
                n_local = _cdiv(c.num_simulated_trajectories, W)
                for _ in range(c.opt_iterations):
                    arrays.append(rng.uniform(1e-6, 1 - 1e-6, (W, n_local, h, d)))
        for k, a in enumerate(arrays):
            noise[f"{name}_{k}"] = a.astype(np.float32)
    return noise


def _case_noise(noise, name):
    return [noise[f"{name}_{k}"] for k in range(len(noise)) if f"{name}_{k}" in noise]


def _jax_injected(name, W, noise, monkeypatch):
    """The JAX package's sharded planner on a W-device CPU mesh, the noise
    injected: under shard_map each device takes its block by axis_index."""
    planner, cfg, s0 = INJECTED[name]
    env, jenv = _injected_envs(name)
    queue = iter(_case_noise(noise, name))

    def block(n):
        n = jnp.asarray(n)
        return n[jax.lax.axis_index("pop")] if n.ndim == 4 else n

    def fake_sample(jcfg, key, mean, std, num_traj):
        n = block(next(queue))
        assert n.shape[0] == num_traj
        return jnp.clip(n * std + mean, jcfg.low, jcfg.high)

    def fake_uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = block(next(queue))
        assert tuple(u.shape) == tuple(shape)
        return u

    monkeypatch.setattr(jplan, "sample_action_sequences", fake_sample)
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)

    def predict_fn(ms, obs, act):
        ns, no, rew, _ = jenv.step(ms, act)
        return ns, no, rew

    c = _config(planner, env, cfg)
    kw = {f: getattr(c, f) for f in c.__dataclass_fields__ if f != "cem_loop"}
    mesh = jplan.make_pop_mesh(jax.devices()[:W])
    state = jnp.asarray(s0, jnp.float32)
    if planner == "icem":
        jcfg = jic.ICemConfig(**kw)
        ps = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
        fn = jplan.plan_step_sharded
    else:
        jcfg = jcs.CemStdConfig(**kw)
        ps = jcs.init_state(jcfg, jax.random.key(0))
        fn = jplan.cem_plan_step_sharded
    steps = []
    for _ in range(PLAN_STEPS):
        # a fresh trace per step: the fakes run while tracing
        res = jax.jit(lambda p, o, m: fn(jcfg, predict_fn, jenv.cost_fn, mesh, p, o, m))(
            ps, jenv.observation(state), state)
        out = dict(action=res.action, expected_cost=res.expected_cost,
                   best_actions=res.best_actions, mean=res.state.mean, std=res.state.std)
        if planner == "icem":
            out.update(elite_actions=res.state.elite_actions, elite_costs=res.state.elite_costs,
                       elite_last_obs=res.state.elite_last_obs)
        steps.append({k: np.asarray(v) for k, v in out.items()})
        ps = res.state
    assert next(queue, None) is None
    return steps


def _port_injected_one_rank(name, noise, monkeypatch):
    """The port's sharded planner over its one-rank group, noise injected
    in the JAX draw order."""
    planner, cfg, s0 = INJECTED[name]
    env = _injected_envs(name)[0]
    queue = iter(_case_noise(noise, name))

    def fake_sample(c, generator, mean, std, num_traj):
        n = next(queue)
        n = n[0] if n.ndim == 4 else n
        assert n.shape[0] == num_traj
        low, high = c.bounds(mean.device)
        return torch.clamp(torch.from_numpy(n) * std + mean, low, high)

    def fake_uniform(generator, shape):
        return torch.from_numpy(next(queue)[0])

    monkeypatch.setattr(tplan, "sample_action_sequences", fake_sample)
    monkeypatch.setattr(tcs, "truncated_uniform", fake_uniform)
    c = _config(planner, env, cfg)
    group = tplan.resolve_group(True, device="cpu")
    fn = tplan.plan_step_sharded if planner == "icem" else tplan.cem_plan_step_sharded
    s = torch.tensor(s0, dtype=torch.float32)
    ps = _port_state(planner, c, env.obs_dim, 0)
    steps = []
    for _ in range(PLAN_STEPS):
        res = fn(c, GroundTruthModel(env=env).predict_fn, env.cost_fn, group, ps,
                 env.observation(s), s)
        steps.append(_record(res))
        ps = res.state
    assert next(queue, None) is None
    return steps


# ---------------------------------------------------------------------------
# one module-wide run: the rank processes work while this one emulates

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    noise = _injected_noise(2)
    np.savez(tmp / "noise2.npz", **noise)
    base = dict(cases=CASES, steps=PLAN_STEPS)
    two = _Ranks(tmp, "w2", 2, "plans", dict(
        base, semantics=True, controllers=str(tmp / "w2"),
        injected=dict(noise=str(tmp / "noise2.npz"),
                      cases={k: (p, c, s.tolist()) for k, (p, c, s) in INJECTED.items()})))
    three = _Ranks(tmp, "w3", 3, "plans", base)
    main = _Ranks(tmp, "main", 2, "main", dict(
        argv=["settings/pendulum/i-cem-blitz.json", "controller_params.horizon=5",
              "controller_params.num_simulated_trajectories=12", "rollout_params.task_horizon=4",
              "training_iterations=2", "checkpoints.save=false"],
        model_dir=str(tmp / "main")), store=f"127.0.0.1:{_free_port()}")
    emulated = {W: {name: _emulate_case(name, W) for name in CASES} for W in (2, 3)}
    mp = pytest.MonkeyPatch()
    try:
        jax_two = {name: _jax_injected(name, 2, noise, mp) for name in INJECTED}
    finally:
        mp.undo()
    return dict(two=two.results(), three=three.results(), main=main.results(),
                emulated=emulated, noise=noise, jax_two=jax_two)


def _assert_same_bits(got, want, what):
    for step, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}, step {step}: {k}")


@pytest.mark.parametrize("W", [2, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_the_emulation_bit_for_bit(runs, name, W):
    ranks = runs["two" if W == 2 else "three"]
    for r, out in enumerate(ranks):
        _assert_same_bits(out[name], runs["emulated"][W][name], f"{name}, rank {r} of {W}")
        _assert_same_bits(out[name], ranks[0][name], f"{name}, rank {r} against rank 0")
    # one collective per CEM iteration
    cfg = CASES[name][3]
    iters = cfg.get("opt_iterations", 3)
    assert all(out["gathers"][name] == PLAN_STEPS * iters for out in ranks), \
        [out["gathers"][name] for out in ranks]


@pytest.mark.parametrize("name", list(INJECTED))
@pytest.mark.parametrize("W", [1, 2])
def test_sharded_plans_match_jax_on_injected_noise(runs, name, W, monkeypatch):
    if W == 1:
        noise = _injected_noise(1)
        want = _jax_injected(name, 1, noise, monkeypatch)
        got = _port_injected_one_rank(name, noise, monkeypatch)
        others = []
    else:
        want = runs["jax_two"][name]
        got, *others = [out["injected_" + name] for out in runs["two"]]
    for step, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **TOL,
                                       err_msg=f"{name}, W={W}, step {step}: {k}")
    for other in others:
        _assert_same_bits(other, got, f"{name}: rank 1 against rank 0")


def test_resolve_group_semantics_at_one_rank():
    assert not dist.is_initialized()
    assert tplan.resolve_group(False, device="cpu") is None
    g = tplan.resolve_group(True, device="cpu")
    assert (g.rank, g.size, g.backend) == (0, 1, "gloo")
    assert tplan.resolve_group("auto", device="cpu") is None
    assert tplan.resolve_group(True, num_parallel=4, device="cpu").size == 1
    assert tplan.resolve_group("auto", num_parallel=1, device="cpu") is None
    # the one-rank group leaves the default process group alone
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="no process group"):
        tplan.make_pop_group([0, 1], device="cpu")


def test_resolve_group_semantics_at_two_ranks(runs):
    sems = [out["semantics"] for out in runs["two"]]
    assert [s["auto"] for s in sems] == [2, 2]
    # capped at one rank: rank 0 plans in a group of one, rank 1 outside it
    assert [s["capped"] for s in sems] == [(0, 1), None]
    assert [s["auto_capped"] for s in sems] == [None, None]
    assert [s["false"] for s in sems] == [None, None]


def test_one_collective_per_cem_iteration(monkeypatch):
    calls = []
    real = dist.all_gather

    def counting(*args, **kwargs):
        calls.append(kwargs.get("group"))
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "all_gather", counting)
    env = PointMass(goal=(0.1, 0.1))
    for planner, fn in (("icem", tplan.plan_step_sharded), ("cem", tplan.cem_plan_step_sharded)):
        c = _config(planner, env, dict(num_simulated_trajectories=20, horizon=4,
                                       opt_iterations=4))
        ps = _port_state(planner, c, env.obs_dim, 0)
        s = torch.tensor([0.2, -0.2, 0.0, 0.0])
        del calls[:]
        group = tplan.resolve_group(True, device="cpu")
        fn(c, GroundTruthModel(env=env).predict_fn, env.cost_fn, group, ps, s, s)
        assert len(calls) == 4 and all(g is group.pg for g in calls), (planner, len(calls))


def test_shifted_elites_are_masked_until_they_exist_and_padding_always(monkeypatch):
    """Rank 1 of 2 (the gather stubbed: both ranks' rows are this rank's)
    with 3 kept elites holds rows 2-3 of the shifted elites, row 3 padding.
    Under a cost that prizes zero actions, the zero rows of the shifted
    elites (step 1: no elites yet) and of the padding (step 2) would win
    if they were not masked invalid: no gathered row may be one."""
    gathered = []
    monkeypatch.setattr(tplan, "gather_rows",
                        lambda g, p: gathered.append(p) or torch.cat([p, p]))
    env = PointMass()
    c = _config("icem", env, dict(num_simulated_trajectories=20, horizon=4, elites_size=10))
    assert c.elites_kept == 3
    ps = _port_state("icem", c, env.obs_dim, 0)
    group = tplan.PopGroup(None, 1, 2, "gloo")
    s = torch.zeros(4)
    for step in range(2):
        ps = tplan.plan_step_sharded(c, GroundTruthModel(env=env).predict_fn,
                                     lambda o, a, n: (a ** 2).sum(-1), group, ps, s, s).state
        actions = gathered[3 * step][:, : c.horizon * 2].reshape(-1, c.horizon, 2)
        zero = (actions[:, :-1] == 0).all(dim=(1, 2)) if step == 0 else (actions == 0).all(
            dim=(1, 2))
        assert torch.isfinite(gathered[3 * step][:, c.horizon * 2]).all() and not zero.any()


def test_nccl_group_refuses_host_rows():
    group = tplan.PopGroup(None, 0, 1, "nccl")
    with pytest.raises(ValueError, match="card tensors"):
        tplan.gather_rows(group, torch.zeros(2, 3))


def test_rank_streams_are_fixed_by_seed_rank_step_and_iteration():
    stream = tplan.RankStream(seed=5, step=3)
    draw = lambda *key: torch.rand(4, generator=tplan.rank_generator(*key, "cpu"))  # noqa: E731
    assert torch.equal(draw(stream, 1, 2), draw(stream, 1, 2))
    others = [draw(stream, 0, 2), draw(stream, 1, 1), draw(stream._replace(step=4), 1, 2),
              draw(stream._replace(seed=6), 1, 2)]
    assert all(not torch.equal(o, draw(stream, 1, 2)) for o in others)
    gen = torch.Generator().manual_seed(1234)
    torch.rand(3, generator=gen)  # a consumed generator keeps its seed
    assert tplan.init_rank_stream(gen) == tplan.RankStream(1234, 0)


# ---------------------------------------------------------------------------
# the controllers

def test_mpc_icem_sharded_swings_the_pendulum_up(runs):
    """One rank here, and the two spawned ranks: tail reward > -0.5 over
    60 steps (tests/test_parallel.py's bar), the two ranks alike."""
    env = ContinuousPendulum()
    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=15,
                   num_simulated_trajectories=32, sharded=True, seed=11, device="cpu",
                   action_sampler_params={"opt_iterations": 2, "noise_beta": 2.0})
    assert ctrl._group.size == 1
    state = torch.tensor([np.pi * 0.9, 0.0])
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    rewards = []
    for _ in range(60):
        a = ctrl.get_action(obs, state)
        state, obs, r, _ = env.step(state, torch.as_tensor(a))
        rewards.append(float(r))
    assert np.mean(rewards[-10:]) > -0.5, np.mean(rewards[-10:])
    two = [out["rewards"] for out in runs["two"]]
    assert two[0] == two[1]
    assert np.mean(two[0][-10:]) > -0.5, np.mean(two[0][-10:])


def test_mpc_cem_std_sharded_steps_point_mass():
    env = PointMass(goal=(0.2, 0.1))
    ctrl = tcs.MpcCemStd(env=env, forward_model=GroundTruthModel(env=env), horizon=10,
                         num_simulated_trajectories=32, sharded=True, seed=12, device="cpu",
                         action_sampler_params={"opt_iterations": 2})
    assert ctrl._group.size == 1
    state = torch.tensor([-0.3, -0.3, 0.0, 0.0])
    ctrl.beginning_of_rollout(observation=state, state=state)
    a = ctrl.get_action(state, state)
    assert a.shape == (2,) and np.all(np.isfinite(a)) and a[0] > 0 and a[1] > 0, a
    assert ctrl._pstate.rank_stream.step == 1


def test_sharded_learned_model_plans_with_the_retrained_weights(monkeypatch):
    from icem_torch.models.ensemble import EnsembleModel
    from icem_torch.runtime.buffer import Rollout, RolloutBuffer

    env = ContinuousPendulum()
    fm = EnsembleModel(env=env, ensemble_size=2, hidden=[16], epochs=1, batch_size=32, seed=0,
                       device="cpu")
    ctrl = MpcICem(env=env, forward_model=fm, horizon=6, num_simulated_trajectories=16,
                   action_sampler_params={"opt_iterations": 2}, sharded=True, seed=4,
                   device="cpu")
    seen = []
    real = tplan.plan_step_sharded

    def spy(*args, **kwargs):
        seen.append(args[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tplan, "plan_step_sharded", spy)
    obs = env.observation(torch.tensor([np.pi, 0.0]))
    ctrl.beginning_of_rollout(observation=obs, state=None)
    assert np.all(np.isfinite(ctrl.get_action(obs, None)))
    before = [x.clone() for x in tree_leaves(seen[-1])]
    rng = np.random.default_rng(0)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    fm.train(RolloutBuffer(rollouts=[Rollout(data=dict(
        observations=o, next_observations=o + 0.01,
        actions=rng.normal(size=(64, 1)).astype(np.float32),
        rewards=np.zeros(64, np.float32), dones=np.zeros(64, np.float32)))]))
    assert np.all(np.isfinite(ctrl.get_action(obs, None)))
    after = tree_leaves(seen[-1])
    assert all(torch.equal(a, b) for a, b in zip(after, tree_leaves(fm.params), strict=True))
    assert any(not torch.equal(a, b) for a, b in zip(after, before, strict=True))


def test_sharded_checkpoint_resumes_the_next_action(tmp_path, runs):
    """One rank here: saved after 3 steps, a fresh controller of another
    seed loads it and gives the next action to the bit. Two ranks: rank 0's
    checkpoint, loaded by both, gives each its next action."""
    env = PointMass(goal=(0.1, -0.2))
    kw = dict(env=env, forward_model=GroundTruthModel(env=env), horizon=6,
              num_simulated_trajectories=20, sharded=True, device="cpu")
    ctrl = MpcICem(seed=1, **kw)
    s = torch.tensor([0.3, 0.2, 0.0, 0.0])
    ctrl.beginning_of_rollout(observation=s, state=s)
    for _ in range(3):
        s = env.step(s, torch.as_tensor(ctrl.get_action(s, s)))[0]
    ctrl.save(tmp_path / "ctrl")
    fresh = MpcICem(seed=2, **kw)
    fresh.load(tmp_path / "ctrl")
    assert fresh._pstate.rank_stream == ctrl._pstate.rank_stream == (1, 3)
    np.testing.assert_array_equal(fresh.get_action(s, s), ctrl.get_action(s, s))
    for out in runs["two"]:
        a, resumed = out["resumed"]
        np.testing.assert_array_equal(a, resumed)
    np.testing.assert_array_equal(runs["two"][0]["resumed"][0], runs["two"][1]["resumed"][0])


def test_sharded_episode_on_the_device_loop(monkeypatch):
    """functional_plan of a sharded controller drives the rollout manager's
    device episode: one gather per CEM iteration of every step."""
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding

    Seeding.set_seed(4)
    env = PointMass(goal=(0.1, 0.1))
    ctrl = tcs.MpcCemStd(env=env, forward_model=GroundTruthModel(env=env), horizon=5,
                         num_simulated_trajectories=16, sharded=True, seed=3, device="cpu")
    calls = []
    real = tplan.gather_rows
    monkeypatch.setattr(tplan, "gather_rows", lambda g, p: calls.append(g.size) or real(g, p))
    rm = RolloutManager(env, dict(task_horizon=4, use_env_states=True), device="cpu")
    (episode,) = rm.sample_on_device(ctrl)
    assert len(episode) == 4 and len(calls) == 4 * ctrl.cfg.opt_iterations
    assert np.all(np.isfinite(episode["actions"]))


# ---------------------------------------------------------------------------
# the sharded planners as compiled steps (runtime/graphs.py's CPU plumbing:
# static buffers, the generators handed over, outputs packed; no graph)

def _sharded_controller(planner, env, seed, **kw):
    cls = MpcICem if planner == "icem" else tcs.MpcCemStd
    asp = dict(elites_size=4, opt_iterations=3)
    if planner == "icem":
        asp.update(noise_beta=0.25, fraction_elites_reused=0.5)
    return cls(env=env, forward_model=GroundTruthModel(env=env), sharded=True, seed=seed,
               device="cpu", action_sampler_params=asp, **kw)


def _assert_same_results(got, want, what):
    _assert_same_bits([_record(got)], [_record(want)], what)
    assert got.state.rank_stream == want.state.rank_stream, what
    assert torch.equal(got.state.generator.get_state(), want.state.generator.get_state()), what


@pytest.mark.parametrize("planner", ["icem", "cem"])
def test_compiled_sharded_plan_steps_give_the_direct_bits(planner):
    """6 HalfCheetah plan steps at one gloo rank through the controller's
    ShardedPlan (rank streams seeded on the host, the body a compiled step)
    against the sharded step called directly with the stream in the state:
    the same bits every step, the streams advanced alike. The compiled body
    has one key per value of ``have_elites`` (2 for iCEM; vanilla CEM has
    no such flag: 1), none per step."""
    env = env_from_string(CHEETAH[0], **CHEETAH[1])
    ctrl = _sharded_controller(planner, env, 5, horizon=3, num_simulated_trajectories=20)
    plan = ctrl._plan_impl()
    assert isinstance(plan, tplan.ShardedPlan) and isinstance(plan.body, graphs.Compiled)
    direct = tplan.plan_step_sharded if planner == "icem" else tplan.cem_plan_step_sharded
    predict = ctrl.forward_model.predict_fn
    via = ctrl.init_plan_state(env.obs_dim, torch.Generator().manual_seed(9))
    ps = ctrl.init_plan_state(env.obs_dim, torch.Generator().manual_seed(9))
    s = env.init_state(torch.Generator().manual_seed(0))
    for step in range(6):
        o = env.observation(s)
        want = direct(ctrl.cfg, predict, env.cost_fn, ctrl._group, ps, o, s)
        got = plan(via, o, s, None)
        _assert_same_results(got, want, f"{planner}, step {step}")
        assert got.state.rank_stream.step == step + 1
        via, ps = got.state, want.state
        s = env.step(s, got.action)[0]
    assert plan.body.num_keys == (2 if planner == "icem" else 1)


def _device_episodes(planner, steps, eager):
    """A sharded controller's device episode on PointMass through the rollout
    manager, with graphs (the CPU plumbing) or without; the gathers each
    made and the control step."""
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding

    Seeding.set_seed(4)
    env = PointMass(goal=(0.1, 0.1))
    ctrl = _sharded_controller(planner, env, 3, horizon=5, num_simulated_trajectories=16)
    rm = RolloutManager(env, dict(task_horizon=steps, use_env_states=True), device="cpu")
    calls = []
    real = tplan.gather_rows
    tplan.gather_rows = lambda g, p: calls.append(g.size) or real(g, p)
    try:
        with graphs.disable_graphs() if eager else contextlib.nullcontext():
            (episode,) = rm.sample_on_device(ctrl)
    finally:
        tplan.gather_rows = real
    return episode, len(calls), rm._control_step(ctrl)


@pytest.mark.parametrize("planner", ["icem", "cem"])
def test_compiled_sharded_device_episode_gives_the_eager_bits(planner):
    """6 control steps of a sharded device episode through the compiled
    control step (the rank stream split off and re-attached on the host)
    against the same episode with graphs disabled: the same transitions to
    the bit, one gather per CEM iteration of every step, and the control
    step's keys are the plan's (2 for iCEM, 1 for CEM), none per step."""
    eager, eager_gathers, _ = _device_episodes(planner, 6, eager=True)
    graph, graph_gathers, step = _device_episodes(planner, 6, eager=False)
    assert isinstance(step.step, graphs.Compiled)
    assert step.step.num_keys == (2 if planner == "icem" else 1)
    assert eager_gathers == graph_gathers == 6 * 3
    assert len(graph) == len(eager) == 6
    for k in eager.field_names:
        np.testing.assert_array_equal(graph[k], eager[k], err_msg=k)


@pytest.mark.parametrize("planner", ["icem", "cem"])
def test_a_compiled_sharded_checkpoint_resumes_the_next_action(tmp_path, planner):
    """Saved after 3 compiled plan steps of an episode: a fresh controller
    of another seed loads it and its next action, through a compiled step
    of its own, is the saved controller's to the bit, and the eager
    planner's."""
    env = PointMass(goal=(0.1, -0.2))
    ctrl = _sharded_controller(planner, env, 1, horizon=6, num_simulated_trajectories=20)
    s = torch.tensor([0.3, 0.2, 0.0, 0.0])
    ctrl.beginning_of_rollout(observation=s, state=s)
    for _ in range(3):
        s = env.step(s, torch.as_tensor(ctrl.get_action(s, s)))[0]
    ctrl.save(tmp_path / "ctrl")
    fresh = _sharded_controller(planner, env, 2, horizon=6, num_simulated_trajectories=20)
    fresh.load(tmp_path / "ctrl")
    assert fresh._pstate.rank_stream == ctrl._pstate.rank_stream == (1, 3)
    eager = _sharded_controller(planner, env, 2, horizon=6, num_simulated_trajectories=20)
    eager.load(tmp_path / "ctrl")
    with graphs.disable_graphs():
        want = eager.get_action(s, s)
    np.testing.assert_array_equal(fresh.get_action(s, s), want)
    np.testing.assert_array_equal(ctrl.get_action(s, s), want)
    assert fresh._plan_impl().body.num_keys == 1 and fresh._pstate.rank_stream == (1, 4)


# ---------------------------------------------------------------------------
# the bootstrap and the driver

_BOOT = r"""
import os, sys
sys.path.insert(0, os.environ["ICEM_REPO"])
import torch.distributed as dist
from icem_torch.parallel.multihost import maybe_initialize_distributed, process_zero
assert maybe_initialize_distributed(device="cpu"), "bootstrap declined to initialize"
assert maybe_initialize_distributed(device="cpu")  # idempotent
assert dist.get_world_size() == 1 and dist.get_rank() == 0 and dist.get_backend() == "gloo"
assert process_zero()
from icem_torch.parallel.plan import resolve_group
assert resolve_group("auto", device="cpu") is None and resolve_group(True, device="cpu").size == 1
dist.destroy_process_group()
print("BOOTSTRAP_OK")
"""


@pytest.mark.parametrize("launch", ["icem_env", "torchrun_env"])
def test_bootstrap_starts_one_process(launch):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ICEM_")}
    env.update(ICEM_REPO=REPO, ICEM_MULTIHOST="1", OMP_NUM_THREADS="1")
    port = str(_free_port())
    if launch == "icem_env":
        env.update(ICEM_COORDINATOR=f"127.0.0.1:{port}", ICEM_NUM_PROCESSES="1",
                   ICEM_PROCESS_ID="0")
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK="0", WORLD_SIZE="1")
    out = subprocess.run([sys.executable, "-c", _BOOT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert "BOOTSTRAP_OK" in out.stdout, f"{out.stdout}\n{out.stderr[-2000:]}"
    assert "multihost: process 0/1 up, gloo on cpu" in out.stdout


_SCALING = r"""
import os, sys
sys.path.insert(0, os.environ["ICEM_REPO"])
import torch, torch.distributed as dist
torch.set_num_threads(1)
from icem_torch.parallel.multihost import maybe_initialize_distributed
from icem_torch.tools import sharded_scaling
assert maybe_initialize_distributed(device="cpu")
sharded_scaling.SETTINGS = "settings/pendulum/i-cem-blitz.json"  # HalfCheetah is slow here
mine = sharded_scaling.measure(torch.device("cpu"), episode_steps=4, plan_steps=4, widths=())
assert dist.get_world_size() == 2 and all(mine["held"].values()), mine["held"]
assert sorted(mine["driver"]) == sorted(mine["plan"]) == ["eager", "graph"]
assert mine["plan"]["graph"]["rows_per_rank"] == 20, mine["plan"]
dist.destroy_process_group()
print("SCALING_OK", mine["rank"])
"""


def test_sharded_scaling_holds_two_ranks_to_the_bit():
    """``tools/sharded_scaling.measure`` at two gloo ranks on the CPU, on
    the pendulum's i-cem-blitz settings as shipped (4 driver steps, 4 plan
    steps): every rank holds that the ranks agree to the bit and that the
    compiled steps give the eager bits."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ICEM_")}
    env.update(ICEM_REPO=REPO, ICEM_MULTIHOST="1", OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", _SCALING], env=dict(env, RANK=str(r)),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"SCALING_OK {r}" in out, out[-3000:]


def test_bootstrap_errors(monkeypatch, capsys):
    monkeypatch.setattr(multihost, "_initialized", False)
    for k in ("ICEM_COORDINATOR", "ICEM_NUM_PROCESSES", "ICEM_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize_distributed(device="cpu") is False  # not asked
    monkeypatch.setenv("ICEM_MULTIHOST", "1")
    monkeypatch.setenv("ICEM_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("ICEM_NUM_PROCESSES", "two")
    with pytest.raises(ValueError, match="ICEM_NUM_PROCESSES='two' is not an integer"):
        multihost.maybe_initialize_distributed(device="cpu")
    # an explicit two-process launch that cannot start raises
    monkeypatch.setenv("ICEM_COORDINATOR", "127.0.0.1")
    monkeypatch.setenv("ICEM_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="explicit 2-process launch"):
        multihost.maybe_initialize_distributed(device="cpu")
    # one process that cannot start warns and goes on alone
    monkeypatch.delenv("ICEM_COORDINATOR")
    monkeypatch.delenv("ICEM_NUM_PROCESSES")
    assert multihost.maybe_initialize_distributed(device="cpu") is False
    assert "WARNING: init_process_group failed" in capsys.readouterr().out
    assert not dist.is_initialized() and multihost.process_zero()


def test_driver_auto_default_shards_at_two_ranks(runs):
    """The two-process launch line through python -m icem_torch.main: the
    shipped "auto" default plans over both ranks (every gather spans 2),
    and the ranks run the same experiment: with no seed given, rank 0's
    random seed is every rank's."""
    outs = runs["main"]
    assert [(o["rank"], o["world"], o["zero"]) for o in outs] == [(0, 2, True), (1, 2, False)]
    assert outs[0]["seed"] == outs[1]["seed"] is not None
    # 2 iterations x 4 steps x 3 CEM iterations, each gathering over 2 ranks
    assert [o["sizes"] for o in outs] == [[2] * 24] * 2
    assert outs[0]["returns"] == outs[1]["returns"] and np.all(np.isfinite(outs[0]["returns"]))


def test_driver_sharded_true_runs_on_one_rank(tmp_path, monkeypatch):
    from icem_torch import main as tmain

    sizes = []
    real = tplan.gather_rows
    monkeypatch.setattr(tplan, "gather_rows", lambda g, p: sizes.append(g.size) or real(g, p))

    info = tmain.main(["icem_torch.main", "settings/pendulum/i-cem-blitz.json",
                       "controller_params.sharded=true", "controller_params.horizon=5",
                       "controller_params.num_simulated_trajectories=12",
                       "rollout_params.task_horizon=5", "training_iterations=1", "seed=2",
                       f"model_dir={tmp_path}", "--device", "cpu"])
    assert np.isfinite(info["train_mean_return"][-1])
    assert sizes == [1] * 5 * 3  # 5 steps of 3 CEM iterations, over the one-rank group
    assert not dist.is_initialized()
