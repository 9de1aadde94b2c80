"""icem_torch's Humanoid3D and HumanoidStandup3D against the JAX package's:
models, observations, costs, rewards and the unhealthy test on identical
states made with numpy from a seed. Their physics is held in
tests/test_torch_spatial_physics.py and tests/test_torch_spatial_kernel_body.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs import humanoid3d as jh
from icem_torch.envs import humanoid3d as th

PAIRS = {"standup": (jh.HumanoidStandup3D, th.HumanoidStandup3D),
         "running": (jh.Humanoid3D, th.Humanoid3D)}


def _states(P, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((P, 46)).astype(np.float32)
    s[:, 2] = rng.uniform(0.0, 2.5, P)
    return s


@pytest.mark.parametrize("kind", list(PAIRS))
def test_model_matches_jax(kind):
    jenv, env = (cls() for cls in PAIRS[kind])
    for f in dataclasses.fields(env.model):
        a, b = getattr(env.model, f.name), getattr(jenv.model, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("kind", list(PAIRS))
def test_observation_cost_and_post_step_match_jax(kind, exclude):
    kw = dict(exclude_current_positions_from_observation=exclude)
    jenv, env = (cls(**kw) for cls in PAIRS[kind])
    S = _states(12, 0)
    S2 = S + 0.02 * np.random.default_rng(1).standard_normal(S.shape).astype(np.float32)
    A = np.random.default_rng(2).uniform(-1, 1, (12, 17)).astype(np.float32)
    obs = env.observation(torch.from_numpy(S))
    jobs = jenv.observation(jnp.asarray(S))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert env.obs_dim == jenv.obs_dim == (44 if exclude else 46)
    nobs = env.observation(torch.from_numpy(S2))
    cost = env.cost_fn(obs, torch.from_numpy(A), nobs)
    jcost = jenv.cost_fn(jobs, jnp.asarray(A), jenv.observation(jnp.asarray(S2)))
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-6, atol=1e-5)
    got = env._post_step(*map(torch.from_numpy, (S, S2, A)))
    want = jax.vmap(jenv._post_step)(*map(jnp.asarray, (S, S2, A)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(w), g.shape),
                                   rtol=1e-6, atol=1e-5)
    if kind == "running":
        S[0, 5] = np.nan
        np.testing.assert_array_equal(
            env.unhealthy_states(env.observation(torch.from_numpy(S))).numpy(),
            np.asarray(jenv.unhealthy_states(jenv.observation(jnp.asarray(S)))))


@pytest.mark.parametrize("kind", list(PAIRS))
def test_init_state_distribution(kind):
    env = PAIRS[kind][1]()
    gen = torch.Generator().manual_seed(0)
    s = torch.stack([env.init_state(gen) for _ in range(64)])
    assert tuple(s.shape) == (64, 46) and s.dtype == torch.float32
    if kind == "standup":
        # supine near the ground, in the recentred chart, knees bent
        assert float((s[:, 2] - 0.16).abs().max()) <= 0.01
        assert float((s[:, 4] + np.pi / 4).abs().max()) <= 0.01
        assert float((s[:, 12] - 0.4).abs().max()) <= 0.01
    else:
        assert float((s[:, 2] - 1.32).abs().max()) <= 0.011
    assert float(s[:, 23:].abs().max()) < 0.1
