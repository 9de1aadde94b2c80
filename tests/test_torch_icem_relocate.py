"""The unrolled plan step on Relocate: icem_torch's against the JAX package's.

Relocate's returns are the one goal-env row of the quality table where the
port and the reference's run differ by more than their seeds' spread, and
its dynamics are all thresholds (the grasp distance, the finger closure,
the lift height), where a small difference in a rollout can flip a decision.
Both planners take their action noise from one numpy queue, as
tests/test_torch_icem.py does on HalfCheetah: the port's draws are recorded
and replayed to the JAX planner in the same order. From the env's start and
from a palm held at the ball with the fingers half closed (rollouts that
grasp, carry and drop it), three plan steps must make the same decisions:
the same executed action, mean, std, elites and costs, at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.icem as jic
from icem_tpu.envs.adroit import Relocate as JaxRelocate
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel
from icem_torch.controllers import icem as tic
from icem_torch.envs.adroit import Relocate
from icem_torch.models.ground_truth import GroundTruthModel

# settings/relocate/i-cem-blitz.json's structure at a small population
CFG = dict(horizon=5, num_simulated_trajectories=64, factor_decrease_num=1.25,
           noise_beta=3.5, elites_size=8, action_dim=30,
           action_low=(-1.0,) * 30, action_high=(1.0,) * 30)


def _start(case):
    s = np.asarray(JaxRelocate().init_state(jax.random.key(3))).copy()
    if case == "at_the_ball":
        s[0:3] = s[30:33] + np.array([0.0, 0.0, 0.01], np.float32)  # palm in the ball
        s[3:30] = 0.5                                                 # fingers half closed
    return s


@pytest.mark.parametrize("case", ["start", "at_the_ball"])
def test_relocate_plan_steps_match_jax_on_injected_noise(monkeypatch, case):
    draws = []
    rng = np.random.default_rng(11)

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

    env, jenv = Relocate(), JaxRelocate()
    cfg, jcfg = tic.ICemConfig(**CFG), jic.ICemConfig(**CFG)
    assert cfg.population_schedule == jcfg.population_schedule == (64, 51, 40)

    s0 = _start(case)
    state, jstate = torch.from_numpy(s0), jnp.asarray(s0)
    obs, jobs = env.observation(state), jenv.observation(jstate)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    predict = GroundTruthModel(env=env).predict_fn
    jpredict = JaxGroundTruthModel(env=jenv).predict_fn
    attached = []

    for step in range(3):
        res = tic.plan_step(cfg, predict, env.cost_fn, pstate, obs, state)
        jres = jic.plan_step(jcfg, jpredict, jenv.cost_fn, jpstate, jobs, jstate)
        msg = f"{case}, plan step {step}"
        np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4,
                                   err_msg=msg)
        np.testing.assert_allclose(float(res.expected_cost), float(jres.expected_cost),
                                   atol=1e-4, rtol=1e-5, err_msg=msg)
        for name in ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs"):
            np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                       np.asarray(getattr(jres.state, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=f"{name}, {msg}")
        pstate, jpstate = res.state, jres.state
        # both real steps from the same state and action
        state, obs, _, _ = env.step(state, res.action)
        jstate, jobs, _, _ = jenv.step(jstate, jnp.asarray(res.action.numpy()))
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, err_msg=msg)
        jstate, jobs = jnp.asarray(state.numpy()), jenv.observation(jnp.asarray(state.numpy()))
        attached.append(float(state[36]))
    assert next(replay, None) is None
    if case == "at_the_ball":
        # the planner grasps: the ball rides the palm after the first step
        assert attached[-1] == 1.0, attached
