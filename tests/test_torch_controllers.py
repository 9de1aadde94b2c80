"""icem_torch's other controllers against the JAX package's: vanilla CEM
(``cem_std``), random shooting and the random policy (``random``), the
open-loop policy, the model-consistency check every MPC controller shares
(``mpc_common``) and MpcICem's plan replay (``visualize_plan``).

PRNG streams cannot match across frameworks, so the draws are injected: the
same uniforms go into both truncated normals, the same held sequences into
both random-shooting planners. The HalfCheetah rollouts of the CEM test run
the JAX package's whole-horizon rollout, compiled once, as
``tests/test_torch_icem.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.cem_std as jcs
import icem_tpu.controllers.icem as jic
import icem_tpu.controllers.random as jrnd
from icem_torch import controllers as tcontrollers
from icem_torch.controllers import cem_std as tcs
from icem_torch.controllers import controller_from_string, register_controller
from icem_torch.controllers import icem as tic
from icem_torch.controllers import random as trnd
from icem_torch.controllers.mpc_common import CONSISTENCY_TOL
from icem_torch.controllers.open_loop import OpenLoopPolicy
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.envs.classic import ContinuousPendulum
from icem_torch.models.ground_truth import GroundTruthModel
from icem_tpu.controllers import _CONTROLLER_REGISTRY as _JAX_CONTROLLER_REGISTRY
from icem_tpu.controllers.open_loop import OpenLoopPolicy as JaxOpenLoopPolicy
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_tpu.envs.classic import ContinuousPendulum as JaxPendulum
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel
from tests.test_torch_icem import KW, _jax_rollout_fn

F32_EPS = float(np.finfo(np.float32).eps)


def test_registry_resolves_the_five_jax_strings(monkeypatch):
    assert set(tcontrollers._CONTROLLER_REGISTRY) == set(_JAX_CONTROLLER_REGISTRY)
    for name, (_, jax_class) in _JAX_CONTROLLER_REGISTRY.items():
        assert controller_from_string(name).__name__ == jax_class, name
    with pytest.raises(ImportError, match="known: "):
        controller_from_string("mpc-nope")
    # on a copy of the registry, as the other files of this process see it
    monkeypatch.setattr(tcontrollers, "_CONTROLLER_REGISTRY",
                        dict(tcontrollers._CONTROLLER_REGISTRY))
    register_controller("mine", "icem_torch.controllers.random", "MpcRandom")
    assert controller_from_string("mine") is trnd.MpcRandom


# ---------------------------------------------------------------------------
# vanilla CEM

def _fake_uniform(queue):
    """A stand-in for jax.random.uniform that returns the next injected
    uniforms (already in the sampler's [1e-6, 1 - 1e-6])."""

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = next(queue)
        assert tuple(u.shape) == tuple(shape)
        return jnp.asarray(u)

    return uniform


@pytest.mark.parametrize("levine", [False, True], ids=["exact", "levine"])
def test_truncated_normal_matches_jax_on_injected_uniforms(monkeypatch, levine):
    """The same uniforms through both inverse-CDF samplers, at means across
    the action range and stds from 0.01 to 0.6.

    Held at 1e-6 where the inverse CDF is well conditioned. Near a
    truncation bound the CDF is close to 1 and its float32 ulp (6e-8) is
    amplified by 1/pdf(z): torch's and XLA's float32 erfc differ by up to
    4e-6 relative, so the two ndtr values at a bound can differ by an ulp,
    and the draws there by scale * 2 ulp / pdf(z) (2.1e-5 at z = 3.4 in this
    sample). Every element is held to 1e-6 plus that conditioning term."""
    rng = np.random.default_rng(0)
    h, d, N = 5, 6, 64
    mean = rng.uniform(-0.9, 0.9, (h, d)).astype(np.float32)
    std = rng.uniform(0.01, 0.6, (h, d)).astype(np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, (N, h, d)).astype(np.float32)
    kw = dict(action_dim=d, action_low=(-1.0,) * d, action_high=(1.0,) * d,
              bounds_like_levine=levine)
    cfg, jcfg = tcs.CemStdConfig(**kw), jcs.CemStdConfig(**kw)

    low, high = cfg.bounds("cpu")
    lower, upper, scale = tcs._bounds(cfg, torch.from_numpy(mean), torch.from_numpy(std),
                                      low, high)
    jlower, jupper, jscale = jcs._bounds(jcfg, jnp.asarray(mean), jnp.asarray(std))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=0, atol=0)
    np.testing.assert_allclose(np.broadcast_to(lower.numpy(), (h, d)),
                               np.broadcast_to(np.asarray(jlower), (h, d)), rtol=1e-6)
    got = tcs.truncated_normal(torch.from_numpy(u), lower, upper, torch.from_numpy(mean), scale)
    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(iter([u])))
    want = np.asarray(jcs.truncated_normal(jax.random.key(0), jlower, jupper,
                                           jnp.asarray(mean), jscale, (N, h, d)))
    gap = np.abs(got.numpy() - want)
    z = (want - mean) / scale.numpy()
    pdf = np.exp(-0.5 * z.astype(np.float64) ** 2) / np.sqrt(2 * np.pi)
    conditioning = scale.numpy() * 2 * F32_EPS / pdf
    assert np.all(gap <= 1e-6 + conditioning), float((gap - conditioning).max())
    well = conditioning < 1e-6
    assert well.mean() > 0.5 and gap[well].max() <= 1e-6
    # within the truncation bounds, as drawn
    assert np.all(got.numpy() >= np.maximum(-1.0, mean + lower.numpy() * scale.numpy()) - 1e-6)
    assert np.all(got.numpy() <= np.minimum(1.0, mean + upper.numpy() * scale.numpy()) + 1e-6)


def test_truncated_uniform_draws_inside_its_range():
    u = tcs.truncated_uniform(torch.Generator().manual_seed(0), (100000,))
    assert float(u.min()) >= 1e-6 and float(u.max()) <= 1 - 1e-6
    assert abs(float(u.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("shift_means,levine", [(True, False), (False, False), (True, True)],
                         ids=["shift", "reset", "shift_levine"])
def test_cem_std_plan_steps_match_jax_on_injected_uniforms(monkeypatch, shift_means, levine):
    """Two plan steps of both packages' vanilla CEM on HalfCheetah (horizon
    5, pop 64, 3 iterations), the same uniforms injected: the same executed
    action, mean, std and expected cost."""
    rng = np.random.default_rng(42)
    draws = []

    def port_uniform(generator, shape):
        u = rng.uniform(1e-6, 1 - 1e-6, shape).astype(np.float32)
        draws.append(u)
        return torch.from_numpy(u)

    monkeypatch.setattr(tcs, "truncated_uniform", port_uniform)
    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(iter(draws)))

    kw = dict(horizon=5, num_simulated_trajectories=64, elites_size=8, action_dim=6,
              action_low=(-1.0,) * 6, action_high=(1.0,) * 6, shift_means=shift_means,
              bounds_like_levine=levine)
    cfg, jcfg = tcs.CemStdConfig(**kw), jcs.CemStdConfig(**kw)
    env, jenv = HalfCheetah(**KW), JaxCheetah(**KW)
    s0 = np.concatenate([np.random.default_rng(0).uniform(-0.1, 0.1, 9),
                         0.1 * np.random.default_rng(1).standard_normal(9)]).astype(np.float32)
    state, jstate = torch.from_numpy(s0), jnp.asarray(s0)
    obs, jobs = env.observation(state), jenv.observation(jstate)
    pstate = tcs.init_state(cfg, torch.Generator().manual_seed(0))
    jpstate = jcs.init_state(jcfg, jax.random.key(0))
    predict = GroundTruthModel(env=env).predict_fn
    jpredict = _jax_rollout_fn(jenv, pad_to=64)

    for step in range(2):
        res = tcs.plan_step(cfg, predict, env.cost_fn, pstate, obs, state)
        jres = jcs.plan_step(jcfg, jpredict, jenv.cost_fn, jpstate, jobs, jstate)
        msg = f"plan step {step}"
        np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4,
                                   err_msg=msg)
        np.testing.assert_allclose(float(res.expected_cost), float(jres.expected_cost),
                                   atol=1e-4, rtol=1e-5, err_msg=msg)
        for name in ("mean", "std"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=f"{name}, {msg}")
        np.testing.assert_allclose(res.best_actions.numpy(), np.asarray(jres.best_actions),
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(res.best_last_obs.numpy(), np.asarray(jres.best_last_obs),
                                   atol=1e-4, rtol=1e-5, err_msg=msg)
        if not shift_means:
            assert float(res.state.mean.abs().max()) == 0.0
        pstate, jpstate = res.state, jres.state
        state, obs, _, _ = env.step(state, res.action)
        jstate = jnp.asarray(state.numpy())
        jobs = jenv.observation(jstate)
    assert len(draws) == 6 and next(iter(draws[6:]), None) is None


# ---------------------------------------------------------------------------
# random shooting and the random policy

def _pendulum_state():
    return np.array([np.pi - 0.3, 0.2], np.float32)


def test_mpc_random_picks_the_jax_argmin_on_injected_sequences(monkeypatch):
    """The same held sequences into both planners on the pendulum: the same
    executed action and expected cost, over 3 steps."""
    rng = np.random.default_rng(5)
    queue = []

    def held(num_traj, horizon, change_every):
        n = -(-horizon // change_every)
        blocks = rng.uniform(-2.0, 2.0, (num_traj, n, 1)).astype(np.float32)
        seq = np.repeat(blocks, change_every, axis=1)[:, :horizon]
        queue.append(seq)
        return seq

    def port_sample(generator, low, high, num_traj, horizon, change_every):
        return torch.from_numpy(held(num_traj, horizon, change_every))

    replay = iter(queue)
    monkeypatch.setattr(trnd, "sample_held_action_sequences", port_sample)
    monkeypatch.setattr(jrnd, "sample_held_action_sequences",
                        lambda key, low, high, n, h, c: jnp.asarray(next(replay)))
    kw = dict(horizon=8, num_simulated_trajectories=32, seed=1,
              action_sampler_params=dict(action_change_frequency=3))
    env, jenv = ContinuousPendulum(), JaxPendulum()
    ctrl = trnd.MpcRandom(env=env, forward_model=GroundTruthModel(env=env), device="cpu", **kw)
    jctrl = jrnd.MpcRandom(env=jenv, forward_model=JaxGroundTruthModel(env=jenv), **kw)
    # unjitted: a compiled plan would keep the first injected sequences
    jctrl._plan = jctrl._plan.__wrapped__
    state = torch.from_numpy(_pendulum_state())
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    jctrl.beginning_of_rollout(observation=jnp.asarray(obs.numpy()),
                               state=jnp.asarray(state.numpy()))
    for _ in range(3):
        a = ctrl.get_action(obs, state)
        ja = jctrl.get_action(np.asarray(obs), jnp.asarray(state.numpy()))
        np.testing.assert_allclose(a, np.asarray(ja), atol=1e-6)
        np.testing.assert_allclose(float(ctrl.last_expected_cost),
                                   float(jctrl.last_expected_cost), rtol=1e-5, atol=1e-5)
        state, obs, _, _ = env.step(state, torch.from_numpy(a))
    assert len(queue) == 3 and ctrl.model_evals_per_timestep == 32 * 8
    # the functional plan takes the same path through the planner
    plan = ctrl.functional_plan()
    gen = ctrl.init_plan_state(3, torch.Generator().manual_seed(0))
    action, gen2 = plan(gen, obs, state)
    assert gen2 is gen and tuple(action.shape) == (1,)


def test_held_action_sequences_hold_and_cover_the_bounds():
    low, high = torch.tensor([-2.0, 0.0]), torch.tensor([2.0, 1.0])
    seq = trnd.sample_held_action_sequences(torch.Generator().manual_seed(0), low, high,
                                            500, 10, 4).numpy()
    assert seq.shape == (500, 10, 2)
    for t in (1, 2, 3, 5, 6, 7, 9):
        np.testing.assert_array_equal(seq[:, t], seq[:, t - 1])
    assert not np.array_equal(seq[:, 4], seq[:, 3]) and not np.array_equal(seq[:, 8], seq[:, 7])
    assert np.all(seq >= low.numpy()) and np.all(seq <= high.numpy())
    assert seq[..., 0].min() < -1.9 and seq[..., 0].max() > 1.9


def test_mpc_random_rejects_a_hold_as_long_as_the_horizon():
    env = ContinuousPendulum()
    with pytest.raises(ValueError, match="action_change_frequency"):
        trnd.MpcRandom(env=env, forward_model=GroundTruthModel(env=env), horizon=5,
                       action_sampler_params=dict(action_change_frequency=5), device="cpu")
    with pytest.raises(TypeError, match="unknown action_sampler_params"):
        trnd.MpcRandom(env=env, forward_model=GroundTruthModel(env=env),
                       action_sampler_params=dict(alpha=0.1), device="cpu")


@pytest.mark.parametrize("freq", [1, 3])
def test_rnd_controller_hold_schedule_matches_jax(freq):
    """The random policy redraws every ``freq`` steps, as the JAX one does,
    on both paths: get_action, and the functional plan of the device
    episode loop, which gives get_action's actions from the same seed."""
    env, jenv = HalfCheetah(**KW), JaxCheetah(**KW)
    ctrl = trnd.RndController(env=env, action_change_frequency=freq, seed=4, device="cpu")
    jctrl = jrnd.RndController(env=jenv, action_change_frequency=freq, seed=4)
    ctrl.beginning_of_rollout(observation=None)
    jctrl.beginning_of_rollout(observation=None)
    acts = np.stack([ctrl.get_action(None) for _ in range(9)])
    jacts = np.stack([np.asarray(jctrl.get_action(None)) for _ in range(9)])
    same = [bool(np.array_equal(acts[t], acts[t - 1])) for t in range(1, 9)]
    jsame = [bool(np.array_equal(jacts[t], jacts[t - 1])) for t in range(1, 9)]
    assert same == jsame == [t % freq != 0 for t in range(1, 9)]
    assert np.all(np.abs(acts) <= 1.0) and acts.shape == (9, 6)

    plan = ctrl.functional_plan()
    ps = ctrl.init_plan_state(env.obs_dim, torch.Generator().manual_seed(4))
    for t in range(9):
        action, ps = plan(ps, None, None)
        np.testing.assert_array_equal(action.numpy(), acts[t])
    # steps since the last draw (at step 8 - 8 % freq)
    assert ps[1] == 9 - (8 - 8 % freq)


def test_open_loop_policy_replays_as_the_jax_one():
    seq = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    pol, jpol = OpenLoopPolicy(seq), JaxOpenLoopPolicy(seq)
    for p in (pol, jpol):
        p.beginning_of_rollout(observation=None)
    for _ in range(5):  # past the horizon the last column repeats
        np.testing.assert_array_equal(pol.get_action(), jpol.get_action())
    sub = pol.get_parallel_policy_copy([1, 3])
    assert sub.population == 2 and sub.horizon == 3
    np.testing.assert_array_equal(sub.action_sequences, seq[[1, 3]])
    single = OpenLoopPolicy(seq[0])
    single.beginning_of_rollout(observation=None)
    assert single.get_action().shape == (2,)
    with pytest.raises(ValueError, match="expected"):
        OpenLoopPolicy(np.zeros(3))


# ---------------------------------------------------------------------------
# the consistency check and the plan replay

MPC = {
    "mpc-icem": dict(action_sampler_params=dict(opt_iterations=2, elites_size=3)),
    "mpc-cem-std": dict(action_sampler_params=dict(opt_iterations=2, elites_size=3)),
    "mpc-random": {},
}


@pytest.mark.parametrize("name", list(MPC))
def test_consistency_check_warns_on_every_mpc_controller(name, capsys):
    """As tests/test_controllers.py holds it for the JAX package: zero drift
    on the honest state, a warning on a drifted one. Under verbose,
    get_action runs the check itself: silent while the env follows the
    executed actions, a warning when the env state is not the one the model
    predicted."""
    env = ContinuousPendulum()
    ctrl = controller_from_string(name)(
        env=env, forward_model=GroundTruthModel(env=env), horizon=5,
        num_simulated_trajectories=8, seed=2, verbose=True, device="cpu", **MPC[name])
    state = torch.from_numpy(_pendulum_state())
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(3):
        a = ctrl.get_action(obs, state)
        state, obs, _, _ = env.step(state, torch.from_numpy(a))
    assert "differs from env" not in capsys.readouterr().out
    # the model holds its prediction of the state the executed action leads to
    np.testing.assert_array_equal(ctrl._model_state.numpy(), state.numpy())
    assert ctrl.check_model_consistency(ctrl._model_state) == 0.0
    capsys.readouterr()
    diff = ctrl.check_model_consistency(ctrl._model_state + 1.0)
    assert diff is not None and diff > CONSISTENCY_TOL
    assert "differs from env" in capsys.readouterr().out
    # an env that did not move: get_action's own check warns at the next step
    ctrl.get_action(obs, state)
    assert "differs from env" not in capsys.readouterr().out
    ctrl.get_action(obs, state)
    assert "differs from env" in capsys.readouterr().out
    assert ctrl.check_model_consistency(None) is None


def test_consistency_check_is_off_without_verbose(capsys):
    env = ContinuousPendulum()
    ctrl = tcs.MpcCemStd(env=env, forward_model=GroundTruthModel(env=env), horizon=5,
                         num_simulated_trajectories=8, seed=2, device="cpu")
    state = torch.from_numpy(_pendulum_state())
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(2):
        ctrl.get_action(obs, state)  # the env does not move
    assert "differs from env" not in capsys.readouterr().out
    np.testing.assert_array_equal(ctrl._model_state.numpy(), state.numpy())


def test_cem_std_rejects_population_decay_and_other_options():
    env = ContinuousPendulum()
    model = GroundTruthModel(env=env)
    with pytest.raises(ValueError, match="factor_decrease_num"):
        tcs.MpcCemStd(env=env, forward_model=model, horizon=5, num_simulated_trajectories=8,
                      factor_decrease_num=1.25, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        tcs.MpcCemStd(env=env, forward_model=model, sharded=True, device="cpu")
    with pytest.raises(TypeError, match="unknown action_sampler_params"):
        tcs.MpcCemStd(env=env, forward_model=model, device="cpu",
                      action_sampler_params=dict(noise_beta=1.0))
    with pytest.raises(ValueError, match="two trajectories"):
        tcs.CemStdConfig(num_simulated_trajectories=1)
    ctrl = tcs.MpcCemStd(env=env, forward_model=model, device="cpu", sharded="auto")
    assert ctrl.model_evals_per_timestep == 40 * 3 * 30 == ctrl.cfg.model_evals_per_timestep


@pytest.mark.parametrize("mode", [True, "all"], ids=["last", "all"])
def test_visualize_plan_reports_the_jax_divergence(mode, capsys):
    """One plan replayed by both packages' MpcICem from the same env state:
    from the planned state the divergence is zero; from a perturbed one both
    report the same divergence, and in "all" mode the same first step."""
    env, jenv = ContinuousPendulum(), JaxPendulum()
    kw = dict(horizon=8, num_simulated_trajectories=16, seed=3, do_visualize_plan=mode,
              action_sampler_params=dict(opt_iterations=2))
    ctrl = tic.MpcICem(env=env, forward_model=GroundTruthModel(env=env), device="cpu", **kw)
    jctrl = jic.MpcICem(env=jenv, forward_model=JaxGroundTruthModel(env=jenv), **kw)
    rng = np.random.default_rng(6)
    plan = rng.uniform(-2, 2, (8, 1)).astype(np.float32)
    s0 = _pendulum_state()
    state = torch.from_numpy(s0)
    obs = env.observation(state)
    # the model's prediction of the plan's last observation
    s = state
    for a in plan:
        s, last_obs, _, _ = env.step(s, torch.from_numpy(a))
    res = tic.PlanResult(action=None, state=None, expected_cost=None,
                         best_actions=torch.from_numpy(plan), best_last_obs=last_obs)
    jres = jic.PlanResult(action=None, state=None, expected_cost=None,
                          best_actions=jnp.asarray(plan), best_last_obs=jnp.asarray(last_obs))
    ctrl._model_state, jctrl._model_state = state, jnp.asarray(s0)

    div = ctrl.visualize_plan(obs, state, res)
    jdiv = jctrl.visualize_plan(jnp.asarray(obs.numpy()), jnp.asarray(s0), jres)
    assert div < 1e-5 and jdiv < 1e-5
    assert capsys.readouterr().out == ""

    div = ctrl.visualize_plan(obs, state + 0.2, res)
    out = capsys.readouterr().out
    jdiv = jctrl.visualize_plan(jnp.asarray(obs.numpy()), jnp.asarray(s0 + 0.2), jres)
    jout = capsys.readouterr().out
    np.testing.assert_allclose(div, jdiv, rtol=1e-5, atol=1e-5)
    assert div > 0.01
    if mode == "all":
        assert "does not match mental model at 0" in out and "orig: " in out
        assert out.splitlines()[0] == jout.splitlines()[0]
    else:
        assert "plan divergence at horizon end" in out and out[:40] == jout[:40]
    assert ctrl.visualize_plan(obs, None, res) is None

    # get_action replays every chosen plan: silent where model and env agree
    ctrl.beginning_of_rollout(observation=obs, state=state)
    ctrl.get_action(obs, state)
    assert "does not match" not in capsys.readouterr().out
