"""icem_torch's analytic envs (classic control, the lander, the dm-suite
cart-pole and point mass) against the JAX package's, step for step on
identical states and actions made with numpy from a seed; and action repeat,
as ``tests/test_envs.py`` holds it for the JAX package: the repeated step
against its raw steps, batched against single, the ground-truth model
against reality, the alive mask after termination, and a repeated planar
env's rollouts against JAX's generic scan.

The same float32 operations in the same order: held at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_torch.envs import base, classic, dm_suite, lander
from icem_torch.models.base import rollout_open_loop
from icem_torch.models.ground_truth import GroundTruthModel
from icem_tpu.envs import base as jbase
from icem_tpu.envs import classic as jclassic
from icem_tpu.envs import dm_suite as jdm
from icem_tpu.envs import lander as jlander
from icem_tpu.models.base import rollout_open_loop as jax_rollout_open_loop
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel

TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (port class, JAX class, kwargs, per-coordinate state ranges)
ENVS = {
    "pendulum": (classic.ContinuousPendulum, jclassic.ContinuousPendulum, {},
                 [(-4.0, 4.0), (-8.0, 8.0)]),
    "mountain_car": (classic.ContinuousMountainCar, jclassic.ContinuousMountainCar, {},
                     [(-1.2, 0.6), (-0.07, 0.07)]),
    "discrete_mountain_car": (classic.DiscreteActionMountainCar,
                              jclassic.DiscreteActionMountainCar, {},
                              [(-1.2, 0.6), (-0.07, 0.07)]),
    "discrete_cartpole": (classic.DiscreteActionCartPole, jclassic.DiscreteActionCartPole, {},
                          [(-2.6, 2.6), (-1.0, 1.0), (-0.25, 0.25), (-1.0, 1.0)]),
    "point_mass": (classic.PointMass, jclassic.PointMass, dict(goal=(0.1, -0.2)),
                   [(-0.5, 0.5)] * 2 + [(-1.0, 1.0)] * 2),
    "lander": (lander.ContinuousLunarLander, jlander.ContinuousLunarLander, {},
               [(-0.5, 0.5), (0.05, 1.5), (-1.0, 1.0), (-1.5, 1.5), (-0.8, 0.8), (-1.0, 1.0)]),
    "cartpole_suite": (dm_suite.CartPoleSuite, jdm.CartPoleSuite, {},
                       [(-1.8, 1.8), (-np.pi, np.pi), (-2.0, 2.0), (-5.0, 5.0)]),
    "double_int_suite": (dm_suite.DoubleIntSuite, jdm.DoubleIntSuite, {},
                         [(-0.5, 0.5)] * 2 + [(-1.0, 1.0)] * 2),
}


def _case(name, P=64, seed=0, **extra):
    port_cls, jax_cls, kw, ranges = ENVS[name]
    env, jenv = port_cls(**kw, **extra), jax_cls(**kw, **extra)
    rng = np.random.default_rng(seed)
    S = np.stack([rng.uniform(lo, hi, P) for lo, hi in ranges], axis=1).astype(np.float32)
    low, high = env.action_space.low, env.action_space.high
    A = rng.uniform(1.2 * low, 1.2 * high, (P, env.action_dim)).astype(np.float32)
    return env, jenv, S, A


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, **TOL)


@pytest.mark.parametrize("name", list(ENVS))
def test_step_matches_jax(name):
    """The population step against the JAX step, vmapped; one trajectory's
    step against the batched one."""
    env, jenv, S, A = _case(name)
    got = env.step_batched(torch.from_numpy(S), torch.from_numpy(A))
    want = jax.jit(jax.vmap(jenv.step))(jnp.asarray(S), jnp.asarray(A))
    for field, g, w in zip(("state", "obs", "reward", "done"), got, want):
        assert g.dtype == torch.float32, field
        _close(g.numpy(), w, field)
    one = env.step(torch.from_numpy(S[3]), torch.from_numpy(A[3]))
    for field, g, w in zip(("state", "obs", "reward", "done"), one, got):
        assert tuple(g.shape) == tuple(w.shape[1:]), field
        _close(g.numpy(), w[3].numpy(), field)


@pytest.mark.parametrize("name", list(ENVS))
def test_observation_cost_and_state_from_observation_match_jax(name):
    env, jenv, S, A = _case(name, seed=1)
    _, _, S2, _ = _case(name, seed=2)
    obs, nxt = env.observation(torch.from_numpy(S)), env.observation(torch.from_numpy(S2))
    _close(obs.numpy(), jenv.observation(jnp.asarray(S)), "observation")
    jobs, jnxt = jnp.asarray(obs.numpy()), jnp.asarray(nxt.numpy())
    _close(env.cost_fn(obs, torch.from_numpy(A), nxt).numpy(),
           jenv.cost_fn(jobs, jnp.asarray(A), jnxt), "cost_fn")
    # the cost over a [h, P] batch, as the planner calls it
    cost_hp = env.cost_fn(obs.reshape(4, 16, -1), torch.from_numpy(A).reshape(4, 16, -1),
                          nxt.reshape(4, 16, -1))
    assert tuple(cost_hp.shape) == (4, 16)
    if env.supports_state_from_obs:
        _close(env.state_from_observation(obs).numpy(),
               jenv.state_from_observation(jobs), "state_from_observation")


@pytest.mark.parametrize("name", list(ENVS))
def test_init_state_lies_in_the_jax_distribution(name):
    """The PRNG streams differ (threefry against Philox): the start states
    are held to the JAX package's support and shape."""
    env, jenv, _, _ = _case(name)
    gen = torch.Generator().manual_seed(0)
    ours = torch.stack([env.init_state(gen) for _ in range(64)]).numpy()
    theirs = np.stack([np.asarray(jenv.init_state(k))
                       for k in jax.random.split(jax.random.key(0), 64)])
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    assert np.all(ours.min(0) >= theirs.min(0) - 0.1 * np.ptp(theirs, 0) - 1e-6)
    assert np.all(ours.max(0) <= theirs.max(0) + 0.1 * np.ptp(theirs, 0) + 1e-6)


def test_discrete_space_matches_jax():
    for n in (2, 3):
        space, jspace = base.DiscreteSpace(n), jbase.DiscreteSpace(n)
        idx = np.arange(n, dtype=np.int32)
        _close(space.embed(torch.from_numpy(idx)).numpy(), jspace.embed(jnp.asarray(idx)))
        a = np.linspace(-1.3, 1.3, 53, dtype=np.float32)[:, None]
        got = space.index(torch.from_numpy(a))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jspace.index(jnp.asarray(a))))
        # an embedded index rounds back to itself
        np.testing.assert_array_equal(space.index(space.embed(torch.from_numpy(idx))[:, None]),
                                      idx)
        draw = space.sample(torch.Generator().manual_seed(1))
        assert tuple(draw.shape) == (1,) and -1.0 < float(draw) < 1.0
        assert (space.dim, space.shape) == (1, (1,))


def test_action_repeat_composes_raw_steps():
    """One control step == N raw steps under the held action, rewards
    summed; the batched path repeats once, not twice; the control rate
    reflects the repeat; a GT model built on a repeated env advances as
    reality does."""
    raw = dm_suite.CartPoleSuite()
    rep = dm_suite.CartPoleSuite(action_repeat=4)
    s0 = raw.init_state(torch.Generator().manual_seed(3))
    a = torch.tensor([0.7])

    s, total = s0, 0.0
    for _ in range(4):
        s, obs, r, _ = raw.step(s, a)
        total += float(r)
    s_rep, obs_rep, r_rep, _ = rep.step(s0, a)
    np.testing.assert_allclose(s_rep.numpy(), s.numpy(), rtol=1e-6)
    np.testing.assert_allclose(obs_rep.numpy(), obs.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(r_rep), total, rtol=1e-5)

    states = torch.stack([s0, s0 + 0.01])
    acts = torch.stack([a, -a])
    s_b, o_b, r_b, _ = rep.step_batched(states, acts)
    for p in range(2):
        s_1, o_1, r_1, _ = rep.step(states[p], acts[p])
        np.testing.assert_allclose(s_b[p].numpy(), s_1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(float(r_b[p]), float(r_1), rtol=1e-6)

    assert rep.get_fps() == pytest.approx(raw.get_fps() / 4)
    # the raw steps stay reachable
    np.testing.assert_array_equal(rep._raw_step(s0, a)[0].numpy(), raw.step(s0, a)[0].numpy())

    gm = GroundTruthModel(env=rep)
    ms, o2, r2 = gm.predict_fn(s0[None], rep.observation(s0)[None], a[None])
    np.testing.assert_allclose(ms[0].numpy(), s_rep.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(r2[0]), float(r_rep), rtol=1e-6)

    # and as the JAX package's repeated step
    jrep = jdm.CartPoleSuite(action_repeat=4)
    js, jo, jr, jd = jrep.step_batched(jnp.asarray(states.numpy()), jnp.asarray(acts.numpy()))
    _close(s_b.numpy(), js, "state")
    _close(o_b.numpy(), jo, "obs")
    _close(r_b.numpy(), jr, "reward")


@pytest.mark.parametrize("name", ["mountain_car", "discrete_cartpole", "lander"])
def test_action_repeat_alive_mask_matches_jax(name):
    """Once a sub-step reports done, later sub-steps add no reward and leave
    the state and observation where they are, as in the JAX package."""
    env, jenv, S, A = _case(name, seed=4, action_repeat=5)
    got = env.step_batched(torch.from_numpy(S), torch.from_numpy(A))
    want = jenv.step_batched(jnp.asarray(S), jnp.asarray(A))
    for field, g, w in zip(("state", "obs", "reward", "done"), got, want):
        _close(g.numpy(), w, field)
    done = got[3].numpy()
    assert 0 < done.sum() < len(done), "the case must hold trajectories that terminate"
    # a trajectory done after its first raw step is frozen there
    first = env._raw_step_batched(torch.from_numpy(S), torch.from_numpy(A))
    ended = first[3].numpy() > 0
    assert ended.any()
    np.testing.assert_array_equal(got[0].numpy()[ended], first[0].numpy()[ended])
    np.testing.assert_array_equal(got[2].numpy()[ended], first[2].numpy()[ended])


def test_repeated_planar_env_rollouts_match_jax_generic_scan():
    """A planar env with action repeat declines the whole-horizon kernel
    path and steps the repeated step: its rollouts equal the composition of
    raw steps, and the JAX package's generic scan, at 2e-4 / 2e-5. At 64
    trajectories the JAX step runs its row engine, the plain version's
    counterpart. The two engines' float32 gap grows with the steps as the
    contacts amplify roundoff, repeated or not: max |d| 4.7e-5, 6.2e-5,
    1.0e-4 and 3.6e-4 at macro steps 1-4 here, against 3.1e-5 ... 5.5e-4
    over the same 8 physics steps without repeat; so the packages are held
    over the first 3 macro steps (6 physics steps)."""
    rep = dm_suite.HalfCheetahSuite(action_repeat=2)
    jrep = jdm.HalfCheetahSuite(action_repeat=2)
    assert rep.rollout_batched(torch.zeros(128, 18), torch.zeros(128, 3, 6)) is None
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-0.1, 0.1, 9), 0.1 * rng.standard_normal(9)]).astype(
        np.float32)
    actions = rng.uniform(-1, 1, (64, 4, 6)).astype(np.float32)
    s0_t = torch.from_numpy(s0)
    traj = rollout_open_loop(GroundTruthModel(env=rep).predict_fn, s0_t, rep.observation(s0_t),
                             torch.from_numpy(actions))
    assert tuple(traj.next_observations.shape) == (4, 64, 18)
    s = s0_t
    for t in range(4):
        for _ in range(2):
            s, obs, _, _ = rep._raw_step(s, torch.from_numpy(actions[0, t]))
        np.testing.assert_allclose(traj.next_observations[t, 0].numpy(), obs.numpy(),
                                   rtol=2e-4, atol=2e-5)
    jtraj = jax_rollout_open_loop(JaxGroundTruthModel(env=jrep).predict_fn, jnp.asarray(s0),
                                  jrep.observation(jnp.asarray(s0)), jnp.asarray(actions))
    np.testing.assert_allclose(traj.next_observations[:3].numpy(),
                               np.asarray(jtraj.next_observations[:3]), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(traj.rewards[:3].numpy(), np.asarray(jtraj.rewards[:3]),
                               rtol=2e-4, atol=2e-5 / rep.dt)
