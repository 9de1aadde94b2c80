"""icem_torch's HalfCheetah against the JAX package's, on identical states and
actions made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.envs.physics import planar

KW = dict(exclude_current_positions_from_observation=True, penalise_flipping=True)


def _states(P, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.1, 0.1, (P, 9)),
                           0.1 * rng.standard_normal((P, 9))], axis=1).astype(np.float32)


def test_rollout_batched_matches_jax():
    jenv, env = JaxCheetah(**KW), HalfCheetah(**KW)
    P, h = 64, 5
    S = _states(P, 0)
    A = np.random.default_rng(1).uniform(-1.2, 1.2, (P, h, 6)).astype(np.float32)
    want = jax.jit(jenv.rollout_batched)(jnp.asarray(S), jnp.asarray(A))
    got = env.rollout_batched(torch.from_numpy(S), torch.from_numpy(A))
    names = ("obs_seq", "next_obs_seq", "actions_tm", "rewards", "final_states")
    shapes = ((h, P, 17), (h, P, 17), (h, P, 6), (h, P), (P, 18))
    for name, shape, g, w in zip(names, shapes, got, want):
        assert tuple(g.shape) == shape, name
        # both run the row engine: float32 roundoff over 5 control steps
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, err_msg=name)
    # actions arrive clipped
    assert float(got[2].abs().max()) <= 1.0


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("dim", [17, 18])
def test_cost_fn_matches_jax(dim, flip):
    kw = dict(exclude_current_positions_from_observation=(dim == 17), penalise_flipping=flip)
    jenv, env = JaxCheetah(**kw), HalfCheetah(**kw)
    rng = np.random.default_rng(dim)
    obs = rng.standard_normal((5, 32, dim)).astype(np.float32)
    obs[..., 1 if dim == 17 else 2] *= 3.0  # root angles past +-pi/2: flips
    act = rng.uniform(-1, 1, (5, 32, 6)).astype(np.float32)
    want = np.asarray(jenv.cost_fn(jnp.asarray(obs), jnp.asarray(act), jnp.asarray(obs)))
    got = env.cost_fn(torch.from_numpy(obs), torch.from_numpy(act), torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cost_fn_rejects_other_dims():
    env = HalfCheetah(**KW)
    with pytest.raises(ValueError, match="17 or 18"):
        env.cost_fn(torch.zeros(3, 16), torch.zeros(3, 6))


def test_real_step_matches_jax():
    """The JAX real step runs the autodiff engine, the port the row engine:
    they agree to roundoff, held at the tolerance tests/test_batched_physics.py
    accepts between the two JAX engines (2e-3 on q, 8e-2 on qd)."""
    jenv, env = JaxCheetah(**KW), HalfCheetah(**KW)
    P = 8
    S = _states(P, 2)
    A = np.random.default_rng(3).uniform(-1, 1, (P, 6)).astype(np.float32)
    js, jobs, jrew, jdone = jax.jit(jax.vmap(jenv.step))(jnp.asarray(S), jnp.asarray(A))
    for p in range(P):
        s, obs, rew, done = env.step(torch.from_numpy(S[p]), torch.from_numpy(A[p]))
        assert tuple(s.shape) == (18,) and tuple(obs.shape) == (17,)
        np.testing.assert_allclose(s[:9].numpy(), np.asarray(js[p, :9]), atol=2e-3)
        np.testing.assert_allclose(s[9:].numpy(), np.asarray(js[p, 9:]), atol=8e-2)
        np.testing.assert_allclose(obs.numpy(), env.observation(s).numpy())
        # reward = x-velocity over the step - control cost: 2e-3 in x over dt
        np.testing.assert_allclose(float(rew), float(jrew[p]), atol=2e-3 / env.dt)
        assert float(done) == float(jdone[p]) == 0.0


def test_step_batched_equals_stepping_one_by_one():
    env = HalfCheetah(**KW)
    S = torch.from_numpy(_states(4, 4))
    A = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (4, 6)).astype(np.float32))
    ns, obs, rew, done = env.step_batched(S, A)
    for p in range(4):
        s1, o1, r1, _ = env.step(S[p], A[p])
        np.testing.assert_allclose(ns[p].numpy(), s1.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(rew[p]), float(r1), atol=1e-5)


def test_state_and_observation_contract():
    env = HalfCheetah(**KW)
    gen = torch.Generator().manual_seed(0)
    s = env.init_state(gen)
    assert tuple(s.shape) == (18,) and s.dtype == torch.float32
    assert float(s[:9].abs().max()) <= 0.1
    assert (env.obs_dim, env.action_dim, env.action_repeat) == (17, 6, 1)
    assert tuple(env.observation(s).shape) == (17,)
    with pytest.raises(AttributeError):
        env.state_from_observation(env.observation(s))
    full = HalfCheetah(exclude_current_positions_from_observation=False)
    assert full.supports_state_from_obs
    assert torch.equal(full.state_from_observation(full.observation(s)), s)
    sample = env.action_space.sample(gen)
    assert tuple(sample.shape) == (6,) and float(sample.abs().max()) <= 1.0
    assert float(env.action_space.clip(torch.full((6,), 3.0)).max()) == 1.0


def test_unported_options_raise():
    # the planar energy valve is ported: a valve model's real step runs the
    # autodiff engine (tests/test_torch_autodiff_physics.py holds it against
    # the JAX package), a valveless model's the row engine
    env = HalfCheetah(**KW)
    env.model = dataclasses.replace(env.model, energy_valve=True)
    S = torch.from_numpy(_states(1, 6)[0])
    A = torch.full((6,), 0.5)
    s, obs, rew, done = env.step(S, A)
    q, qd = planar.step(env.model, S[:9], S[9:], A)
    np.testing.assert_allclose(s.numpy(), torch.cat([q, qd]).numpy(), rtol=0, atol=1e-5)
    assert bool(torch.isfinite(obs).all()) and float(done) == 0.0
    # action repeat is ported: the whole-horizon path declines it, as the
    # JAX one does, and the caller steps the repeated step
    repeated = HalfCheetah(action_repeat=2, **KW)
    assert repeated.rollout_batched(torch.zeros(4, 18), torch.zeros(4, 3, 6)) is None
