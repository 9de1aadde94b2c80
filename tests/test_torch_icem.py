"""The slice as a whole: icem_torch's plan step against the JAX package's.

PRNG streams cannot match across frameworks, so both planners draw their
action noise from one numpy queue: ``sample_action_sequences`` is replaced in
both packages, the port's draws are recorded and replayed to the JAX planner
in the same order. Then two plan steps on HalfCheetah must make the same
decisions: the same executed action, mean, std, elites and costs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.icem as jic
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_torch.controllers import icem as tic
from icem_torch.convert import icem_state_from_arrays
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.models.ground_truth import GroundTruthModel

KW = dict(exclude_current_positions_from_observation=True, penalise_flipping=True)
CFG = dict(horizon=5, num_simulated_trajectories=64, factor_decrease_num=1.25,
           noise_beta=0.25, elites_size=8, action_dim=6,
           action_low=(-1.0,) * 6, action_high=(1.0,) * 6)


def _jax_rollout_fn(jenv, pad_to):
    """The JAX env's whole-horizon rollout, compiled once: every population
    is padded to one size, so the three CEM iterations share a program."""
    roll = jax.jit(jenv.rollout_batched)

    def rollout(states, actions):
        P = actions.shape[0]
        pad = pad_to - P
        st = jnp.concatenate([states, jnp.broadcast_to(states[:1], (pad,) + states.shape[1:])])
        ac = jnp.concatenate([actions, jnp.zeros((pad,) + actions.shape[1:])])
        obs, next_obs, acts, rew, final = roll(st, ac)
        return obs[:, :P], next_obs[:, :P], acts[:, :P], rew[:, :P], final[:P]

    def predict(ms, obs, act):
        raise AssertionError("the whole-horizon rollout serves every call")

    predict.rollout = rollout
    return predict


def test_plan_steps_match_jax_on_injected_noise(monkeypatch):
    draws = []
    rng = np.random.default_rng(42)

    def port_sampler(cfg, generator, mean, std, num_traj):
        noise = rng.standard_normal((num_traj, cfg.horizon, cfg.action_dim)).astype(np.float32)
        draws.append(noise)
        low, high = cfg.bounds(mean.device)
        return torch.clamp(torch.from_numpy(noise) * std + mean, low, high)

    replay = iter(draws)

    def jax_sampler(cfg, key, mean, std, num_traj):
        noise = next(replay)
        assert noise.shape[0] == num_traj
        return jnp.clip(jnp.asarray(noise) * std + mean, cfg.low, cfg.high)

    monkeypatch.setattr(tic, "sample_action_sequences", port_sampler)
    monkeypatch.setattr(jic, "sample_action_sequences", jax_sampler)

    env, jenv = HalfCheetah(**KW), JaxCheetah(**KW)
    cfg, jcfg = tic.ICemConfig(**CFG), jic.ICemConfig(**CFG)
    assert cfg.population_schedule == jcfg.population_schedule == (64, 51, 40)
    assert cfg.elites_kept == jcfg.elites_kept == 2

    s0 = np.concatenate([np.random.default_rng(0).uniform(-0.1, 0.1, 9),
                         0.1 * np.random.default_rng(1).standard_normal(9)]).astype(np.float32)
    state, jstate = torch.from_numpy(s0), jnp.asarray(s0)
    obs, jobs = env.observation(state), jenv.observation(jstate)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    predict = GroundTruthModel(env=env).predict_fn
    jpredict = _jax_rollout_fn(jenv, pad_to=72)

    for step in range(2):
        res = tic.plan_step(cfg, predict, env.cost_fn, pstate, obs, state)
        jres = jic.plan_step(jcfg, jpredict, jenv.cost_fn, jpstate, jobs, jstate)
        msg = f"plan step {step}"
        np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4,
                                   err_msg=msg)
        np.testing.assert_allclose(float(res.expected_cost), float(jres.expected_cost),
                                   atol=1e-4, rtol=1e-5, err_msg=msg)
        for name in ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=f"{name}, {msg}")
        assert res.state.have_elites and bool(jres.state.have_elites)
        pstate, jpstate = res.state, jres.state
        # the port's real step; both planners start the next step from it
        state, obs, _, _ = env.step(state, res.action)
        jstate = jnp.asarray(state.numpy())
        jobs = jenv.observation(jstate)
    # per step: fresh draws at iteration 0, the shifted elites' draw, then
    # the two decayed iterations
    assert [d.shape[0] for d in draws[:4]] == [64, 2, 51, 40]
    assert next(replay, None) is None


TIE_CASES = {
    "dense_integer_ties": np.random.default_rng(0).integers(0, 4, 200).astype(np.float32),
    "non_finite_rank_last": np.array([3.0, np.nan, -np.inf, 1.0, np.inf, 1.0, 0.5, np.nan,
                                      -2.0, 1.0], np.float32),
    "all_tied": np.zeros(37, np.float32),
}


@pytest.mark.parametrize("case", list(TIE_CASES))
def test_top_k_ascending_is_stable_and_ranks_non_finite_last(case):
    costs = TIE_CASES[case]
    k = min(16, costs.shape[0])
    got = tic.top_k_ascending(torch.from_numpy(costs), k).numpy()
    sane = np.where(np.isfinite(costs), costs, np.inf)
    np.testing.assert_array_equal(got, np.argsort(sane, kind="stable")[:k])
    np.testing.assert_array_equal(got, np.asarray(jic.top_k_ascending(jnp.asarray(costs), k)))


@pytest.mark.parametrize("pop,elites,gamma,iters", [
    (40, 10, 1.25, 3), (32768, 512, 1.25, 3), (100, 5, 1.5, 5), (7, 10, 1.1, 2)])
def test_config_schedule_matches_jax(pop, elites, gamma, iters):
    kw = dict(num_simulated_trajectories=pop, elites_size=elites,
              factor_decrease_num=gamma, opt_iterations=iters)
    cfg, jcfg = tic.ICemConfig(**kw), jic.ICemConfig(**kw)
    for name in ("population_schedule", "num_elites", "elites_kept",
                 "model_evals_per_timestep"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_refit_uses_population_std():
    cfg = tic.ICemConfig(**{**CFG, "alpha": 0.0})
    rng = np.random.default_rng(3)
    acts = rng.uniform(-1, 1, (20, 5, 6)).astype(np.float32)
    costs = rng.standard_normal(20).astype(np.float32)
    mean, std, ea, ec, _ = tic._refit(cfg, torch.zeros(5, 6), torch.ones(5, 6),
                                      torch.from_numpy(acts), torch.from_numpy(costs),
                                      torch.zeros(20, 17))
    order = np.argsort(costs, kind="stable")[: cfg.num_elites]
    np.testing.assert_allclose(std.numpy(), acts[order].std(axis=0), atol=1e-6)  # ddof=0
    np.testing.assert_allclose(mean.numpy(), acts[order].mean(axis=0), atol=1e-6)
    np.testing.assert_array_equal(ec.numpy(), costs[order])


def test_state_carried_from_jax():
    jcfg = jic.ICemConfig(**CFG)
    jstate = jic.init_state(jcfg, 17, jax.random.key(0))._replace(
        mean=jnp.full((5, 6), 0.25), have_elites=jnp.asarray(True))
    fields = {k: np.asarray(v) for k, v in jstate._asdict().items() if k != "key"}
    gen = torch.Generator().manual_seed(1)
    state = icem_state_from_arrays(fields, "cpu", gen)
    assert state.have_elites is True and state.generator is gen
    for name in ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs"):
        got = getattr(state, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), fields[name])


def test_mpc_icem_get_action_on_cpu():
    env = HalfCheetah(**KW)
    ctrl = tic.MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=3,
                       num_simulated_trajectories=16, seed=0, device="cpu",
                       action_sampler_params=dict(noise_beta=0.25, elites_size=4))
    state = env.init_state(torch.Generator().manual_seed(0))
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    a = ctrl.get_action(obs, state)
    assert a.shape == (6,) and np.all(np.abs(a) <= 1.0)
    assert np.isfinite(float(ctrl.last_expected_cost))
    # the functional plan from the same seed makes the same decision
    plan = ctrl.functional_plan()
    action, pstate = plan(ctrl.init_plan_state(17, torch.Generator().manual_seed(0)),
                          obs, state)
    np.testing.assert_allclose(action.numpy(), a, atol=1e-6)
    assert pstate.have_elites


def test_unported_options_raise():
    # the scanned loop is ported (tests/test_torch_icem_scan.py); an unknown
    # loop is refused
    assert tic.ICemConfig(cem_loop="scan").cem_loop == "scan"
    with pytest.raises(ValueError, match="cem_loop"):
        tic.ICemConfig(cem_loop="while")
    env = HalfCheetah(**KW)
    model = GroundTruthModel(env=env)
    with pytest.raises(NotImplementedError, match="sharded"):
        tic.MpcICem(env=env, forward_model=model, sharded=True, device="cpu")
    # the plan replay is ported (tests/test_torch_controllers.py); its video
    # mode needs the video writer, which is not
    with pytest.raises(NotImplementedError, match="visualize_plan"):
        tic.MpcICem(env=env, forward_model=model, do_visualize_plan="record", device="cpu")
    with pytest.raises(TypeError, match="unknown action_sampler_params"):
        tic.MpcICem(env=env, forward_model=model, device="cpu",
                    action_sampler_params=dict(nosie_beta=1.0))


def _linear_predict(ms, obs, act):
    """x' = 0.9 x + a, obs = x: exactly integrable in numpy."""
    ns = 0.9 * ms + act
    return ns, ns, torch.zeros(ns.shape[0])


def _linear_cost(obs, act, next_obs):
    return torch.sum(next_obs**2, dim=-1) + 0.1 * torch.sum(act**2, dim=-1)


@pytest.mark.parametrize("alpha,use_mean", [(0.1, True), (0.0, False)])
def test_plan_step_matches_numpy_reference_mechanics(monkeypatch, alpha, use_mean):
    """tests/test_reference_parity.py's check on the port: the generic
    per-step rollout loop, the decay schedule, elite shift and keep (cost
    reuse), argmin, top-k, refit, mean shift and std reset against a numpy
    transliteration of the reference algorithm on the same noise."""
    from tests.test_reference_parity import _np_reference_icem_multistep

    cfg = tic.ICemConfig(
        horizon=6, num_simulated_trajectories=20, factor_decrease_num=1.3,
        opt_iterations=3, elites_size=6, alpha=alpha, init_std=0.5,
        use_mean_actions=use_mean, fraction_elites_reused=0.5, noise_beta=1.0,
        action_dim=2, action_low=(-1.0, -1.0), action_high=(1.0, 1.0))
    rng = np.random.default_rng(42)
    draws = []

    def sampler(cfg, generator, mean, std, num_traj):
        noise = rng.standard_normal((num_traj, cfg.horizon, cfg.action_dim))
        draws.append(noise)
        low, high = cfg.bounds(mean.device)
        return torch.clamp(torch.tensor(noise, dtype=torch.float32) * std + mean, low, high)

    monkeypatch.setattr(tic, "sample_action_sequences", sampler)
    pstate = tic.init_state(cfg, 2, torch.Generator().manual_seed(0))
    x0 = torch.full((2,), 1.5)
    results, per_step = [], []
    for _ in range(2):
        n = len(draws)
        res = tic.plan_step(cfg, _linear_predict, _linear_cost, pstate, x0, x0)
        per_step.append(draws[n:])
        results.append(res)
        pstate = res.state

    ref = _np_reference_icem_multistep(cfg, per_step)
    for step, (res, (r_exec, r_cost, r_mean, r_ea, r_ec)) in enumerate(zip(results, ref)):
        msg = f"plan step {step}"
        np.testing.assert_allclose(res.action.numpy(), r_exec, atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(float(res.expected_cost), r_cost, rtol=2e-5, err_msg=msg)
        np.testing.assert_allclose(res.state.mean.numpy(), r_mean, atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(res.state.elite_costs.numpy(), r_ec, rtol=2e-5, err_msg=msg)
        np.testing.assert_allclose(res.state.elite_actions.numpy(), r_ea, atol=2e-5,
                                   err_msg=msg)
        np.testing.assert_allclose(res.state.std.numpy(), 0.5, rtol=1e-6, err_msg=msg)
