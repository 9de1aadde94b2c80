"""icem_torch's Ant3D against the JAX package's, on identical states and
actions made with numpy from a seed: observations, costs, the whole-horizon
rollout (B2's plain version on the CPU) and the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs.ant3d import Ant3D as JaxAnt3D
from icem_torch.envs import env_from_string, register_env
from icem_torch.envs.ant3d import Ant3D
from icem_torch.envs.cheetah import HalfCheetah

FULL = dict(exclude_current_positions_from_observation=False)


def _states(P, seed):
    """Near Ant3D's start distribution: standing, ankles bent."""
    rng = np.random.default_rng(seed)
    q = np.zeros((P, 14))
    q[:, 2] = 0.48
    q[:, 7::2] = 0.9
    q += rng.uniform(-0.1, 0.1, (P, 14)) * np.array([1, 1, 0.1, 0.1, 0.1, 0.3] + [1] * 8)
    qd = 0.05 * rng.standard_normal((P, 14))
    return np.concatenate([q, qd], axis=1).astype(np.float32)


def test_rollout_batched_matches_jax():
    jenv, env = JaxAnt3D(**FULL), Ant3D(**FULL)
    P, h = 16, 4
    S = _states(P, 0)
    A = np.random.default_rng(1).uniform(-1.2, 1.2, (P, h, 8)).astype(np.float32)
    want = jax.jit(jenv.rollout_batched)(jnp.asarray(S), jnp.asarray(A))
    got = env.rollout_batched(torch.from_numpy(S), torch.from_numpy(A))
    names = ("obs_seq", "next_obs_seq", "actions_tm", "rewards", "final_states")
    shapes = ((h, P, 28), (h, P, 28), (h, P, 8), (h, P), (P, 28))
    for name, shape, g, w in zip(names, shapes, got, want):
        assert tuple(g.shape) == shape, name
        # both run the row engine: float32 roundoff over 4 control steps
        # (qd and the x-velocity reward are the loosest)
        atol = {"rewards": 2e-2}.get(name, 1e-2 if name != "actions_tm" else 0.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol + 1e-6, err_msg=name)
    np.testing.assert_allclose(got[1][..., :14].numpy(), np.asarray(want[1])[..., :14],
                               atol=1e-3, err_msg="positions")
    assert float(got[2].abs().max()) <= 1.0   # actions arrive clipped
    cost = env.cost_fn(*got[:3])
    np.testing.assert_allclose(cost.numpy(), np.asarray(jenv.cost_fn(*want[:3])), atol=2e-2)


@pytest.mark.parametrize("exclude", [True, False])
def test_observation_matches_jax(exclude):
    kw = dict(exclude_current_positions_from_observation=exclude)
    jenv, env = JaxAnt3D(**kw), Ant3D(**kw)
    S = _states(8, 2)
    np.testing.assert_array_equal(env.observation(torch.from_numpy(S)).numpy(),
                                  np.asarray(jenv.observation(jnp.asarray(S))))
    assert env.obs_dim == jenv.obs_dim == (26 if exclude else 28)
    assert env.supports_state_from_obs == (not exclude)


def test_cost_and_unhealthy_match_jax():
    jenv, env = JaxAnt3D(**FULL), Ant3D(**FULL)
    rng = np.random.default_rng(3)
    obs = _states(40, 4).reshape(5, 8, 28)
    obs[0, :, 2] = rng.uniform(-0.5, 1.5, 8)      # heights out of the healthy band
    obs[1, 0, 5] = np.nan                         # a non-finite state is unhealthy
    nxt = obs + 0.01 * rng.standard_normal(obs.shape).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 8, 8)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (obs, act, nxt)]
    j = [jnp.asarray(x) for x in (obs, act, nxt)]
    np.testing.assert_allclose(env.cost_fn(*t).numpy(), np.asarray(jenv.cost_fn(*j)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(env.are_states_unhealthy(t[0]).numpy(),
                                  np.asarray(jenv.are_states_unhealthy(j[0])))
    excluded = Ant3D()
    with pytest.raises(AttributeError, match="exclude_current_positions"):
        excluded.cost_fn(t[0][..., 2:], t[1], t[2][..., 2:])
    with pytest.raises(AttributeError, match="GT model"):
        excluded.state_from_observation(t[0][..., 2:])


def test_step_reward_and_done_match_jax_post_step():
    jenv, env = JaxAnt3D(**FULL), Ant3D(**FULL)
    S = _states(8, 5)
    S2 = S + 0.01 * np.random.default_rng(6).standard_normal(S.shape).astype(np.float32)
    S2[:3, 2] = [0.1, 0.5, 1.2]
    A = np.random.default_rng(7).uniform(-1, 1, (8, 8)).astype(np.float32)
    obs, rew, done = env._post_step(*map(torch.from_numpy, (S, S2, A)))
    jobs, jrew, jdone = jax.vmap(jenv._post_step)(*map(jnp.asarray, (S, S2, A)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs))
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_state_contract_and_step():
    env = Ant3D(**FULL)
    gen = torch.Generator().manual_seed(0)
    s = env.init_state(gen)
    assert tuple(s.shape) == (28,) and s.dtype == torch.float32
    assert 0.38 < float(s[2]) < 0.58 and float(s[7]) > 0.7
    assert (env.obs_dim, env.action_dim, env.action_repeat) == (28, 8, 1)
    ns, obs, rew, done = env.step(s, torch.zeros(8))
    assert tuple(ns.shape) == (28,) and bool(torch.isfinite(ns).all())
    assert float(done) == 0.0
    S = torch.stack([env.init_state(gen) for _ in range(3)])
    A = torch.rand(3, 8, generator=gen) * 2 - 1
    nss, _, rews, _ = env.step_batched(S, A)
    for p in range(3):
        s1, _, r1, _ = env.step(S[p], A[p])
        np.testing.assert_allclose(nss[p].numpy(), s1.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(rews[p]), float(r1), atol=1e-5)
    repeated = Ant3D(action_repeat=2, **FULL)
    with pytest.raises(NotImplementedError, match="action_repeat"):
        repeated.rollout_batched(S, torch.zeros(3, 2, 8))


def test_registry_resolves_the_ported_envs():
    ant = env_from_string("Ant", **FULL)
    assert isinstance(ant, Ant3D) and ant.name == "Ant" and ant.obs_dim == 28
    assert isinstance(env_from_string("HalfCheetah"), HalfCheetah)
    for name in ("Humanoid", "HumanoidStandup"):
        assert env_from_string(name).name == name
    with pytest.raises(ImportError, match="known: .*'Ant'"):
        env_from_string("Hopper")
    register_env("MyAnt", "icem_torch.envs.ant3d", "Ant3D")
    assert isinstance(env_from_string("MyAnt"), Ant3D)
