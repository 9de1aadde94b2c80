"""The scanned CEM loop on the 23-dof Humanoid3D: icem_torch's plan step
against the JAX package's ``_plan_step_scan``, the JAX side run eagerly.

The quality table's Humanoid rows are the one place where the port and the
reference's run differed by far more than their seeds' spread, so the
planner is held on that model too, as tests/test_torch_icem_scan.py holds
it on Ant3D: both planners take their action noise from one numpy table
(the JAX loop's sampler is a ``jax.pure_callback`` that looks the draw up by
its key). The JAX Humanoid step compiles for many minutes, so the JAX plan
step runs under ``jax.disable_jit()``, at a short horizon and a small
population. Two plan steps from a Humanoid3D start state must make the same
decisions: the same executed action, mean, std, elites and costs, at 1e-4.
The elites' last observations are states h steps ahead, so they are held at
the 23-dof step's own tolerance summed over the horizon: h x 1e-4 on q and
h x 1e-3 on qd (tests/test_torch_spatial_physics.py; a state at the max_qd
clip turns single ulps into about 1e-3 of qd a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import icem_tpu.controllers.icem as jic
from icem_tpu.envs.humanoid3d import Humanoid3D as JaxHumanoid3D
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel
from icem_torch.controllers import icem as tic
from icem_torch.envs.humanoid3d import Humanoid3D
from icem_torch.models.ground_truth import GroundTruthModel

# settings/humanoid/i-cem-blitz.json's structure at a short horizon and a small population
CFG = dict(horizon=2, num_simulated_trajectories=16, factor_decrease_num=1.25,
           noise_beta=1.0, elites_size=4, cem_loop="scan", action_dim=17,
           action_low=(-1.0,) * 17, action_high=(1.0,) * 17)
KW = dict(exclude_current_positions_from_observation=False)


def _key_id(data) -> tuple:
    return tuple(int(v) for v in np.asarray(data).reshape(-1))


def test_scanned_plan_steps_on_the_humanoid_match_eager_jax(monkeypatch):
    cfg, jcfg = tic.ICemConfig(**CFG), jic.ICemConfig(**CFG)
    assert cfg.population_schedule == jcfg.population_schedule
    E, n0, h, d = cfg.elites_kept, CFG["num_simulated_trajectories"], cfg.horizon, 17
    assert E == jcfg.elites_kept >= 1

    rng = np.random.default_rng(17)
    queue, by_key = [], {}

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

    env, jenv = Humanoid3D(**KW), JaxHumanoid3D(**KW)
    assert env.action_dim == jenv.action_dim == d
    s0 = np.asarray(jenv.init_state(jax.random.key(5)))
    state, jstate = torch.from_numpy(s0.copy()), jnp.asarray(s0)
    obs, jobs = env.observation(state), jenv.observation(jstate)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    predict = GroundTruthModel(env=env).predict_fn
    jpredict = JaxGroundTruthModel(env=jenv).predict_fn

    for step in range(2):
        next_key = plan_noise(jpstate.key)
        res = tic.plan_step(cfg, predict, env.cost_fn, pstate, obs, state)
        with jax.disable_jit():
            jres = jic.plan_step(jcfg, jpredict, jenv.cost_fn, jpstate, jobs, jstate)
        assert not queue
        msg = f"plan step {step}"
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jres.state.key)),
                                      np.asarray(jax.random.key_data(next_key)))
        np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4,
                                   err_msg=msg)
        np.testing.assert_allclose(float(res.expected_cost), float(jres.expected_cost),
                                   atol=1e-4, rtol=1e-5, err_msg=msg)
        for name in ("mean", "std", "elite_actions", "elite_costs"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=f"{name}, {msg}")
        got, want = res.state.elite_last_obs.numpy(), np.asarray(jres.state.elite_last_obs)
        nq = env.nq
        np.testing.assert_allclose(got[:, :nq], want[:, :nq], rtol=0, atol=h * 1e-4,
                                   err_msg=f"elite_last_obs q, {msg}")
        np.testing.assert_allclose(got[:, nq:], want[:, nq:], rtol=0, atol=h * 1e-3,
                                   err_msg=f"elite_last_obs qd, {msg}")
        assert res.state.have_elites and bool(jres.state.have_elites)
        pstate, jpstate = res.state, jres.state
        # the port's real step; both planners start the next step from it
        state, obs, _, _ = env.step(state, res.action)
        jstate = jnp.asarray(state.numpy())
        jobs = jenv.observation(jstate)
