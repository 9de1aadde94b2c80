"""The compiled step (``icem_torch/runtime/graphs.py``) on the CPU.

On the CPU there is no CUDA graph, but every compiled step runs its buffer
plumbing: the arguments split into inputs, generators and static leaves, a
cache key, static input buffers, generators of its own that take the
caller's state and hand it back, and the outputs taken out of one flat
tensor per dtype. These tests hold that plumbing to the function called
directly, to the bit: the plan steps of every controller, the restructured
device episode against a verbatim copy of the loop it replaced, the
generator streams and checkpoints, and the JAX package through the wrapper.
Capture and replay themselves are held on the card (tests/test_torch_cuda.py
and chip_smoke.py's ``[graph]`` phase).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.icem as jic
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_torch.controllers import icem as tic
from icem_torch.controllers.cem_std import MpcCemStd
from icem_torch.controllers.random import MpcRandom, RndController
from icem_torch.envs import env_from_string
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.models.ensemble import EnsembleModel
from icem_torch.models.ground_truth import GroundTruthModel
from icem_torch.runtime import graphs
from icem_torch.runtime.buffer import Rollout
from icem_torch.runtime.graphs import Compiled, disable_graphs, graphs_enabled
from icem_torch.runtime.rollout import _FIELDS, RolloutManager
from icem_torch.runtime.seeding import Seeding

KW = dict(exclude_current_positions_from_observation=True, penalise_flipping=True)
CFG = dict(horizon=5, num_simulated_trajectories=64, factor_decrease_num=1.25,
           noise_beta=0.25, elites_size=4, action_dim=6,
           action_low=(-1.0,) * 6, action_high=(1.0,) * 6)
# the 20-step runs: the plain B1's cost on the CPU is its horizon's dispatch
SMALL = dict(CFG, horizon=2, num_simulated_trajectories=16)


def _assert_trees_equal(a, b):
    la, sa = torch.utils._pytree.tree_flatten(a)
    lb, sb = torch.utils._pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.allclose(x, y, rtol=0.0, atol=0.0, equal_nan=True)
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert x == y


def _cheetah_start(seed=0):
    env = HalfCheetah(**KW)
    state = env.init_state(torch.Generator().manual_seed(seed))
    return env, state, env.observation(state)


# -- the wrapper's plumbing over real plan steps -----------------------------

@pytest.mark.parametrize("cem_loop", ["unrolled", "scan"])
def test_compiled_icem_plan_steps_give_the_direct_bits(cem_loop):
    """20 HalfCheetah plan steps: the planner state each step returns feeds
    the next call, the first step (no elites) and the later ones are two
    keys, and every output is the direct call's bits."""
    env, state, obs = _cheetah_start()
    cfg = tic.ICemConfig(**SMALL, cem_loop=cem_loop)
    fn = partial(tic.plan_step, cfg, GroundTruthModel(env=env).predict_fn, env.cost_fn)
    step = Compiled(fn, in_place=(3,))
    direct = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(3))
    via = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(3))
    for _ in range(20):
        want = fn(direct, obs, state, None)
        got = step(via, obs, state, None)
        _assert_trees_equal(got, want)
        assert got.state.generator is via.generator  # the caller's, advanced
        direct, via = want.state, got.state
        state, obs, _, _ = env.step(state, want.action)
    assert step.num_keys == 2  # have_elites False, then True


def test_compiled_steps_of_the_other_controllers_give_the_direct_bits():
    """MpcCemStd's and MpcRandom's plan steps, and RndController's
    functional plan, whose hold counter is a static leaf: one key per
    counter value."""
    env, state, obs = _cheetah_start(1)
    model = GroundTruthModel(env=env)
    cem = MpcCemStd(env=env, forward_model=model, horizon=2, num_simulated_trajectories=12,
                    seed=1, device="cpu")
    rnd = MpcRandom(env=env, forward_model=model, horizon=3, num_simulated_trajectories=12,
                    action_sampler_params=dict(action_change_frequency=2), device="cpu")
    policy = RndController(env=env, action_change_frequency=3, device="cpu")
    cem_fn = cem._plan_impl().fn
    pc = [cem.init_plan_state(env.obs_dim, torch.Generator().manual_seed(5)) for _ in "ab"]
    gr = [torch.Generator().manual_seed(6) for _ in "ab"]
    plan = policy.functional_plan()
    ps = [policy.init_plan_state(env.obs_dim, torch.Generator().manual_seed(7)) for _ in "ab"]
    step_plan = Compiled(plan)
    for _ in range(7):
        want, got = cem_fn(pc[0], obs, state, None), cem._plan_impl()(pc[1], obs, state, None)
        _assert_trees_equal(got, want)
        pc = [want.state, got.state]
        _assert_trees_equal(rnd.plan_step(gr[1], obs, state), rnd._plan_step(gr[0], obs, state))
        with disable_graphs():
            want_a, ps[0] = plan(ps[0], obs, None)
        got_a, ps[1] = step_plan(ps[1], obs, None)
        _assert_trees_equal((got_a, ps[1]), (want_a, ps[0]))
        state, obs, _, _ = env.step(state, want.action)
    assert cem._plan_impl().num_keys == 1
    assert step_plan.num_keys == 3  # the counter 3 (draw), 1 and 2 (hold)


def test_new_weight_tensors_make_a_new_key():
    """An ensemble's weights are read in place: an optimizer step changes
    no key and the next plan reads it; new tensors (a refit with
    reset_on_train) make a new key."""
    env = env_from_string("ContinuousPendulum")
    model = EnsembleModel(env=env, ensemble_size=2, hidden=(8,), propagation="ts1",
                          seed=0, device="cpu")
    ctrl = tic.MpcICem(env=env, forward_model=model, horizon=3, num_simulated_trajectories=8,
                       action_sampler_params=dict(elites_size=2, opt_iterations=2),
                       seed=1, device="cpu")
    obs = torch.tensor([0.3, -0.2, 0.1])
    step = ctrl._plan_impl()
    results = []
    for change in ("none", "in place", "new tensors"):
        if change == "in place":
            with torch.no_grad():
                model.net.net_0_w.mul_(-2.0)
        elif change == "new tensors":
            model._reinit_params()
        gen_state = model._generator.get_state()
        pstate = ctrl.init_plan_state(3, torch.Generator().manual_seed(2))
        got = step(pstate, obs, {}, ctrl.live_model_params)
        model._generator.set_state(gen_state)
        with disable_graphs():
            pstate = ctrl.init_plan_state(3, torch.Generator().manual_seed(2))
            want = step(pstate, obs, {}, ctrl.live_model_params)
        _assert_trees_equal(got, want)
        results.append((got.action, step.num_keys))
    assert [n for _, n in results] == [1, 1, 2]
    assert not torch.equal(results[0][0], results[1][0])  # the in-place step was read


# -- the cache key -------------------------------------------------------------

def _toy(x, flag, gen, w):
    y = x * w["scale"] + torch.rand(x.shape, generator=gen, dtype=x.dtype)
    return (y if flag else -y), gen


KEY_CASES = {
    "same": lambda a: a,
    "shape": lambda a: {**a, "x": torch.zeros(4)},
    "dtype": lambda a: {**a, "x": torch.zeros(3, dtype=torch.float64)},
    "static leaf": lambda a: {**a, "flag": False},
    "weight pointer": lambda a: {**a, "w": {"scale": torch.tensor(2.0)}},
    "stride": lambda a: {**a, "x": torch.zeros(3, 2)[:, 0]},
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_the_cache_key(case):
    """Same shapes, dtypes, static leaves and weight pointers give one key;
    any of them changed gives a new one."""
    step = Compiled(_toy, in_place=(3,))
    base = dict(x=torch.zeros(3), flag=True, gen=torch.Generator().manual_seed(0),
                w={"scale": torch.tensor(2.0)})
    step(base["x"], base["flag"], base["gen"], base["w"])
    other = KEY_CASES[case](dict(base, x=torch.ones(3), gen=torch.Generator().manual_seed(9)))
    got = step(other["x"], other["flag"], other["gen"], other["w"])
    assert step.num_keys == (1 if case == "same" else 2)
    gen = torch.Generator().manual_seed(9)
    _assert_trees_equal(got, _toy(other["x"], other["flag"], gen, other["w"]))


# -- generators and checkpoints -----------------------------------------------

def test_generators_follow_their_streams_episode_after_episode():
    """A new generator per episode (``Seeding.generator_for``) is served by
    the graph's own generator, re-seeded from the caller's state: each
    episode draws its stream's numbers, its generator advances as an eager
    one, and no episode makes a new key."""
    Seeding.set_seed(4)
    step = Compiled(lambda gen, x: (torch.randn(x.shape, generator=gen) + x, gen))
    x = torch.zeros(5)
    for episode in range(4):
        gen = Seeding.generator_for(f"rollout/train/0/{episode}/plan", "cpu")
        ref = Seeding.generator_for(f"rollout/train/0/{episode}/plan", "cpu")
        for _ in range(3):
            got, out_gen = step(gen, x)
            want = torch.randn(5, generator=ref)
            assert out_gen is gen and torch.equal(got, want)
            assert torch.equal(gen.get_state(), ref.get_state())
    assert step.num_keys == 1


def test_a_checkpoint_resumes_the_same_draws(tmp_path):
    env, state, obs = _cheetah_start(2)
    model = GroundTruthModel(env=env)

    def build():
        return tic.MpcICem(env=env, forward_model=model, horizon=2,
                           num_simulated_trajectories=16, seed=5, device="cpu",
                           action_sampler_params=dict(elites_size=4))

    ctrl = build()
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(3):
        a = ctrl.get_action(obs, state)
        state, obs, _, _ = env.step(state, torch.from_numpy(a))
    path = str(tmp_path / "ctrl.pkl")
    ctrl.save(path)
    nxt = [ctrl.get_action(obs, state) for _ in range(2)]
    fresh = build()
    fresh.load(path)
    np.testing.assert_array_equal([fresh.get_action(obs, state) for _ in range(2)], nxt)


# -- the restructured device episode -------------------------------------------

def _verbatim_device_episode(rm, policy, plan, mode, stream, chunk) -> Rollout:
    """``RolloutManager._device_episode`` as it was before the control step
    became a compiled step, kept verbatim as the reference."""
    env, device, horizon = rm.env, rm.device, rm.task_horizon
    model_params = getattr(policy, "live_model_params", None)
    state, obs = env.reset_with_mode(Seeding.generator_for(f"{stream}/env", device), mode)
    pstate = policy.init_plan_state(env.obs_dim,
                                    Seeding.generator_for(f"{stream}/plan", device))
    has_success = env.is_success(obs, torch.zeros(env.action_dim, device=device),
                                 obs) is not None
    widths = (env.obs_dim, env.obs_dim, env.action_dim, 1, 1, 1, 1)
    buf = torch.zeros((horizon, sum(widths)), device=device)
    host = np.zeros(tuple(buf.shape), np.float32)
    done_before = torch.zeros((), device=device)
    zero = torch.zeros((), device=device)

    for start in range(0, horizon, chunk):
        stop = min(start + chunk, horizon)
        for t in range(start, stop):
            action, pstate = plan(pstate, obs,
                                  state if rm.use_env_states else None, model_params)
            state2, obs2, rew, done = env.step(state, action)
            blown = ~(torch.isfinite(obs2).all() & torch.isfinite(state2).all())
            blown_f = blown.to(torch.float32)
            dead = (done_before > 0) | blown
            keep = (1.0 - done_before) * (1.0 - blown_f)
            state2 = torch.where(dead, state, state2)
            obs2 = torch.where(dead, obs, obs2)
            rew = torch.where(keep > 0, rew, zero)
            succ = env.is_success(obs, action, obs2) if has_success else zero
            done_after = torch.maximum(done_before, torch.maximum(done, blown_f))
            buf[t] = torch.cat([obs, obs2, action,
                                torch.stack([rew, done_after, keep, succ])])
            state, obs, done_before = state2, obs2, done_after
        host[start:stop] = buf[start:stop].cpu().numpy()

    bounds = np.cumsum((0,) + widths)
    fields = {name: host[:, a:b] if i < 3 else host[:, a]
              for i, (name, a, b) in enumerate(zip(_FIELDS, bounds[:-1], bounds[1:]))}
    t = int(fields["keep"].sum())
    rew = fields["rewards"][:t]
    if rm.only_final_reward and t > 0:
        rew = np.concatenate([np.zeros(t - 1, rew.dtype), rew[-1:]])
    data = dict(observations=fields["observations"][:t],
                next_observations=fields["next_observations"][:t],
                actions=fields["actions"][:t], rewards=rew, dones=fields["dones"][:t])
    if has_success:
        data["successes"] = fields["successes"][:t]
    return Rollout(data=data)


EPISODE_CASES = {
    # (env, env kwargs, controller, task horizon)
    "halfcheetah": ("HalfCheetah", KW, "icem", 4),
    "pendulum": ("ContinuousPendulum", {}, "icem", 8),
    # random actions topple the hopper: its episode terminates and freezes
    "hopper": ("Hopper", {}, "random", 40),
}


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("case", list(EPISODE_CASES))
def test_device_episode_equals_the_loop_it_replaced(case, chunk):
    name, kwargs, kind, horizon = EPISODE_CASES[case]
    env = env_from_string(name, **kwargs)
    if kind == "icem":
        policy = tic.MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=2,
                             num_simulated_trajectories=12, seed=0, device="cpu",
                             action_sampler_params=dict(elites_size=3, opt_iterations=2))
    else:
        policy = RndController(env=env, action_change_frequency=2, device="cpu")
    rm = RolloutManager(env, {"task_horizon": horizon, "use_env_states": True}, device="cpu")
    Seeding.set_seed(11)
    got = [rm._device_episode(policy, "train", f"s/{i}", chunk or horizon) for i in range(2)]
    Seeding.set_seed(11)
    with disable_graphs():
        want = [_verbatim_device_episode(rm, policy, policy.functional_plan(), "train",
                                         f"s/{i}", horizon) for i in range(2)]
    for g, w in zip(got, want):
        assert g.field_names == w.field_names
        for k in w.field_names:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if case == "hopper":
        assert min(len(r) for r in got) < horizon  # the freeze path ran
    assert rm._control_step(policy).num_keys >= 1


# -- the JAX package through the wrapper ---------------------------------------

def test_compiled_plan_steps_match_jax_on_injected_noise(monkeypatch):
    """tests/test_torch_icem.py's parity check, the port's plan step called
    through ``Compiled``: the same decisions as the JAX planner on the same
    draws, at that test's tolerances."""
    draws = []
    rng = np.random.default_rng(42)

    def port_sampler(cfg, generator, mean, std, num_traj):
        noise = rng.standard_normal((num_traj, cfg.horizon, cfg.action_dim)).astype(np.float32)
        draws.append(noise)
        low, high = cfg.bounds(mean.device)
        return torch.clamp(torch.from_numpy(noise) * std + mean, low, high)

    replay = iter(draws)

    def jax_sampler(cfg, key, mean, std, num_traj):
        return jnp.clip(jnp.asarray(next(replay)) * std + mean, cfg.low, cfg.high)

    monkeypatch.setattr(tic, "sample_action_sequences", port_sampler)
    monkeypatch.setattr(jic, "sample_action_sequences", jax_sampler)
    env, jenv = HalfCheetah(**KW), JaxCheetah(**KW)
    cfg, jcfg = tic.ICemConfig(**CFG), jic.ICemConfig(**CFG)
    state = env.init_state(torch.Generator().manual_seed(0))
    obs = env.observation(state)
    jstate = jnp.asarray(state.numpy())
    jobs = jenv.observation(jstate)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    step = Compiled(partial(tic.plan_step, cfg, GroundTruthModel(env=env).predict_fn,
                            env.cost_fn), in_place=(3,))
    roll = jax.jit(jenv.rollout_batched)

    def jrollout(states, actions):
        # every population padded to the first iteration's, so one program
        # serves the three CEM iterations
        P, pad = actions.shape[0], 66 - actions.shape[0]
        st = jnp.concatenate([states, jnp.broadcast_to(states[:1], (pad,) + states.shape[1:])])
        ac = jnp.concatenate([actions, jnp.zeros((pad,) + actions.shape[1:])])
        obs, next_obs, acts, rew, final = roll(st, ac)
        return obs[:, :P], next_obs[:, :P], acts[:, :P], rew[:, :P], final[:P]

    def jpredict(ms, o, a):
        raise AssertionError("the whole-horizon rollout serves every call")

    jpredict.rollout = jrollout
    for i in range(2):
        res = step(pstate, obs, state, None)
        jres = jic.plan_step(jcfg, jpredict, jenv.cost_fn, jpstate, jobs, jstate)
        np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4)
        for name in ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=f"{name}, step {i}")
        pstate, jpstate = res.state, jres.state
        state, obs, _, _ = env.step(state, res.action)
        jstate = jnp.asarray(state.numpy())
        jobs = jenv.observation(jstate)
    assert next(replay, None) is None


# -- disable_graphs and --eager -------------------------------------------------

def test_disable_graphs_nests_and_restores():
    calls = []
    step = Compiled(lambda x: calls.append(x) or x + 1)
    x = torch.zeros(2)
    assert graphs_enabled()
    with disable_graphs():
        with disable_graphs():
            assert not graphs_enabled()
            step(x)
        assert not graphs_enabled()
        step(x)
    assert graphs_enabled()
    assert all(c is x for c in calls) and step.num_keys == 0  # eager: the caller's tensor
    step(x)
    assert calls[-1] is not x and step.num_keys == 1  # the static buffer


def test_the_eager_flag_reaches_disable_graphs(monkeypatch):
    from icem_torch import main as tmain

    seen = []
    monkeypatch.setattr(tmain, "_run", lambda params, device: seen.append(graphs_enabled()))
    tmain.main(["prog", "settings/pendulum/i-cem-blitz.json", "--device", "cpu", "--eager"])
    tmain.main(["prog", "settings/pendulum/i-cem-blitz.json", "--device", "cpu"])
    assert seen == [False, True]


def test_a_sharded_controller_compiles_its_plan_and_control_steps(capsys):
    """On the CPU, as over an NCCL group on the card, the sharded plan step
    and the device episode's control step are compiled steps, and nothing
    says that the controller plans eagerly."""
    env = env_from_string("ContinuousPendulum")
    ctrl = tic.MpcICem(env=env, forward_model=GroundTruthModel(env=env), sharded=True,
                       device="cpu")
    assert "plans eagerly" not in capsys.readouterr().out
    assert not ctrl.plans_eagerly and isinstance(ctrl._plan_impl().body, graphs.Compiled)
    rm = RolloutManager(env, {"task_horizon": 2}, device="cpu")
    assert isinstance(rm._control_step(ctrl).step, graphs.Compiled)


def test_a_sharded_controller_runs_its_episodes_eagerly(capsys):
    """A sharded controller over a gloo group on the card, whose gather goes
    through the host, plans and runs its device episodes eagerly, and says
    so. The controller's device is set to the card after it is built on the
    CPU (nothing runs there: the choice alone is held)."""
    env = env_from_string("ContinuousPendulum")
    rm = RolloutManager(env, {"task_horizon": 2}, device="cpu")
    on_card = tic.MpcICem(env=env, forward_model=GroundTruthModel(env=env), sharded=True,
                          device="cpu")
    on_card.device = torch.device("cuda")
    assert on_card._group.backend == "gloo" and on_card.plans_eagerly
    on_card._announce_group()
    assert "MpcICem: a gloo group on the card plans eagerly" in capsys.readouterr().out
    assert not isinstance(on_card._plan_impl().body, graphs.Compiled)
    assert not isinstance(rm._control_step(on_card).step, graphs.Compiled)
