"""The scanned CEM loop: icem_torch's plan step on Ant3D against the JAX
package's ``_plan_step_scan``.

PRNG streams cannot match across frameworks, so both planners take their
action noise from one table made with numpy. The JAX loop is a ``lax.scan``
that traces its sampler once, so a replay queue cannot feed it: its sampler
is a ``jax.pure_callback`` that looks the draw up by the data of the key it
was given. The keys are split on the host exactly as the loop splits them
(three per iteration), so each key names one draw. The port draws in the
same order (n_0 fresh rows, then E rows for the shift, at every iteration).
Two plan steps must make the same decisions: the same executed action, mean,
std, elites and costs, at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.icem as jic
from icem_tpu.envs.ant3d import Ant3D as JaxAnt3D
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel
from icem_torch.controllers import icem as tic
from icem_torch.envs.ant3d import Ant3D
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.models.ground_truth import GroundTruthModel

KW = dict(exclude_current_positions_from_observation=False)
CFG = dict(horizon=5, num_simulated_trajectories=64, factor_decrease_num=1.25,
           noise_beta=1.0, elites_size=8, cem_loop="scan", action_dim=8,
           action_low=(-1.0,) * 8, action_high=(1.0,) * 8)


def _key_id(data) -> tuple:
    return tuple(int(v) for v in np.asarray(data).reshape(-1))


def test_scanned_plan_steps_match_jax_on_injected_noise(monkeypatch):
    cfg, jcfg = tic.ICemConfig(**CFG), jic.ICemConfig(**CFG)
    assert cfg.population_schedule == jcfg.population_schedule == (64, 51, 40)
    E, n0, h, d = cfg.elites_kept, 64, cfg.horizon, cfg.action_dim
    assert E == jcfg.elites_kept == 2

    rng = np.random.default_rng(7)
    queue = []      # the port's draws, in order
    by_key = {}     # the JAX loop's draws, by the data of their key

    def plan_noise(key):
        """The draws of one plan step, and the key each is drawn with."""
        for _ in range(cfg.opt_iterations):
            key, k_sample, k_shift = jax.random.split(key, 3)
            for k, n in ((k_sample, n0), (k_shift, E)):
                noise = rng.standard_normal((n, h, d)).astype(np.float32)
                queue.append(noise)
                by_key[_key_id(jax.random.key_data(k))] = noise
        return key

    def port_sampler(cfg_, generator, mean, std, num_traj):
        noise = queue.pop(0)
        assert noise.shape[0] == num_traj
        low, high = cfg_.bounds(mean.device)
        return torch.clamp(torch.from_numpy(noise) * std + mean, low, high)

    def jax_sampler(cfg_, key, mean, std, num_traj):
        shape = jax.ShapeDtypeStruct((num_traj, h, d), jnp.float32)
        noise = jax.pure_callback(lambda data: by_key[_key_id(data)], shape,
                                  jax.random.key_data(key))
        return jnp.clip(noise * std + mean, cfg_.low, cfg_.high)

    monkeypatch.setattr(tic, "sample_action_sequences", port_sampler)
    monkeypatch.setattr(jic, "sample_action_sequences", jax_sampler)

    env, jenv = Ant3D(**KW), JaxAnt3D(**KW)
    s0 = np.asarray(jenv.init_state(jax.random.key(3)))
    state, jstate = torch.from_numpy(s0.copy()), jnp.asarray(s0)
    obs, jobs = env.observation(state), jenv.observation(jstate)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    predict = GroundTruthModel(env=env).predict_fn
    jplan = jax.jit(lambda ps, o, s: jic.plan_step(
        jcfg, JaxGroundTruthModel(env=jenv).predict_fn, jenv.cost_fn, ps, o, s))

    for step in range(2):
        next_key = plan_noise(jpstate.key)
        res = tic.plan_step(cfg, predict, env.cost_fn, pstate, obs, state)
        jres = jplan(jpstate, jobs, jstate)
        assert not queue
        msg = f"plan step {step}"
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jres.state.key)),
                                      np.asarray(jax.random.key_data(next_key)))
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


def _counting_predict(n_rows):
    """x' = 0.9 x + a (obs = x) that records each rollout's population."""
    def predict(ms, obs, act):
        n_rows.append(act.shape[0])
        ns = 0.9 * ms + act
        return ns, ns, torch.zeros(ns.shape[0])
    return predict


def _quadratic_cost(obs, act, next_obs):
    return torch.sum(next_obs**2, dim=-1) + 0.1 * torch.sum(act**2, dim=-1)


@pytest.mark.parametrize("shift,keep", [(True, True), (False, True), (True, False),
                                        (False, False)])
def test_scan_rolls_out_one_population_and_masks_the_rest(shift, keep):
    """Every iteration rolls out n_0 + E rows (n_0 alone without a tail);
    the executed action is a valid row's, and elites come from valid rows."""
    cfg = tic.ICemConfig(horizon=4, num_simulated_trajectories=20, elites_size=4,
                         fraction_elites_reused=0.5, cem_loop="scan",
                         shift_elites_over_time=shift, keep_previous_elites=keep,
                         action_dim=2, action_low=(-1.0, -1.0), action_high=(1.0, 1.0))
    E = cfg.elites_kept
    rows = []
    pstate = tic.init_state(cfg, 2, torch.Generator().manual_seed(0))
    x0 = torch.full((2,), 1.5)
    for _ in range(2):
        res = tic.plan_step(cfg, _counting_predict(rows), _quadratic_cost, pstate, x0, x0)
        assert bool(torch.isfinite(res.expected_cost))
        assert bool(torch.isfinite(res.state.elite_costs).all())
        pstate = res.state
    tail = E if (shift or keep) else 0
    assert rows == [20 + tail] * (2 * cfg.opt_iterations) * cfg.horizon


def test_mpc_icem_auto_resolves_scan_for_spatial_envs():
    ant = Ant3D(**KW)
    ctrl = tic.MpcICem(env=ant, forward_model=GroundTruthModel(env=ant), horizon=3,
                       num_simulated_trajectories=8, seed=0, device="cpu",
                       action_sampler_params=dict(elites_size=2))
    assert ctrl.cfg.cem_loop == "scan"
    cheetah = HalfCheetah()
    ctrl = tic.MpcICem(env=cheetah, forward_model=GroundTruthModel(env=cheetah),
                       device="cpu")
    assert ctrl.cfg.cem_loop == "unrolled"
    with pytest.raises(ValueError, match="cem_loop"):
        tic.ICemConfig(cem_loop="while")
