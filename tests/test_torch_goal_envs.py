"""icem_torch's goal-conditioned envs (``MaskedGoalSpaceEnv``, FetchReach,
FetchPickAndPlace, Door, Relocate) against the JAX package's, on identical
states and actions made with numpy from a seed: step, observation, cost and
success, batched and single; the ground-truth model's rollouts; and Ant3D
with action repeat against its raw steps and the JAX package's repeated step.

The states are drawn where the envs' switches act: a gripper at its object
and closing, objects held, falling and pushed; a palm at the door handle with
the latch open, every bonus tier of the door; a ball lifted, carried and near
its target. The same float32 operations in the same order: held at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_torch.envs import adroit, base, fetch
from icem_torch.envs.ant3d import Ant3D
from icem_torch.models.base import rollout_open_loop
from icem_torch.models.ground_truth import GroundTruthModel
from icem_tpu.envs import adroit as jadroit
from icem_tpu.envs import base as jbase
from icem_tpu.envs import fetch as jfetch
from icem_tpu.envs.ant3d import Ant3D as JaxAnt3D
from icem_tpu.models.base import rollout_open_loop as jax_rollout_open_loop
from icem_tpu.models.ground_truth import GroundTruthModel as JaxGroundTruthModel

TOL = dict(rtol=1e-5, atol=1e-5)


def _fetch_reach_states(rng, P):
    ee = rng.uniform(fetch.WS_LOW - 0.05, fetch.WS_HIGH + 0.05, (P, 3))
    grip = rng.uniform(-0.01, 0.06, (P, 1))
    vel = rng.normal(0.0, 0.5, (P, 3))
    # half the goals within reach of the threshold, so success and the
    # sparse cost take both values
    goal = ee + rng.normal(0.0, 0.03, (P, 3)) * np.repeat([[1.0], [10.0]], P // 2, axis=0)
    return np.concatenate([ee, grip, vel, goal], axis=1)


def _fpp_states(rng, P):
    ee = rng.uniform(fetch.WS_LOW + 0.05, fetch.WS_HIGH - 0.05, (P, 3))
    grip = rng.uniform(0.015, 0.05, (P, 1))       # closing past GRIP_CLOSED or not
    # objects at the gripper (grasp, push contact) and away from it
    obj = ee + rng.normal(0.0, 0.04, (P, 3)) * np.repeat([[0.5], [3.0]], P // 2, axis=0)
    obj[::3, 2] = fetch.TABLE_HEIGHT + fetch.OBJ_HALF_HEIGHT + rng.uniform(-0.01, 0.01, len(obj[::3]))
    obj_vel = rng.normal(0.0, 0.3, (P, 3))
    attached = rng.integers(0, 2, (P, 1)).astype(np.float64)
    goal = obj + rng.normal(0.0, 0.05, (P, 3))
    return np.concatenate([ee, grip, obj, obj_vel, attached, goal], axis=1)


def _door_states(rng, P):
    frame = np.array([0.0, -0.25]) + rng.uniform([-0.3, -0.05], [0.0, 0.05], (P, 2))
    door = rng.uniform(0.0, 1.6, P)               # every bonus tier
    latch = rng.uniform(0.0, 1.8, P)
    hand = rng.uniform(-1.0, 1.0, (P, 28))
    hand[:, 3:] = rng.uniform(0.0, 1.0, (P, 25))  # grasp above and below GRASP_MIN
    handle = np.stack([frame[:, 0] + 0.35 * np.cos(door + np.pi / 2),
                       frame[:, 1] + 0.35 * np.sin(door + np.pi / 2),
                       np.full(P, 0.25)], axis=1)
    # half the palms at the handle (within REACH_DIST), half away
    palm = handle + rng.normal(0.0, 0.02, (P, 3)) * np.repeat([[1.0], [10.0]], P // 2, axis=0)
    return np.concatenate([hand, door[:, None], latch[:, None], palm, frame], axis=1)


def _relocate_states(rng, P):
    hand = rng.uniform(-1.0, 1.0, (P, 30))
    hand[:, :3] = rng.uniform([-0.4, -0.4, 0.03], [0.4, 0.4, 0.5], (P, 3))
    hand[:, 3:] = rng.uniform(0.0, 1.0, (P, 27))
    obj = hand[:, :3] + rng.normal(0.0, 0.03, (P, 3)) * np.repeat([[0.5], [5.0]], P // 2, axis=0)
    obj[::4, 2] = 0.035
    obj_vel = rng.normal(0.0, 0.3, (P, 3))
    attached = rng.integers(0, 2, (P, 1)).astype(np.float64)
    # targets at every bonus distance from the ball
    target = obj + rng.normal(0.0, 0.04, (P, 3)) * rng.choice([0.5, 1.5, 5.0], (P, 1))
    return np.concatenate([hand, obj, obj_vel, attached, target], axis=1)


def _fetch_actions(rng, P, dim):
    return rng.uniform(-1.2, 1.2, (P, dim))


def _hand_actions(rng, P, dim):
    a = rng.uniform(-1.2, 1.2, (P, dim))
    a[:, 3:] = rng.uniform(-0.2, 1.2, (P, dim - 3))  # fingers mostly closing
    return a


# name -> (port class, JAX class, kwargs, states, actions)
ENVS = {
    "fetch_reach": (fetch.FetchReach, jfetch.FetchReach, dict(sparse=False),
                    _fetch_reach_states, _fetch_actions),
    "fetch_reach_sparse": (fetch.FetchReach, jfetch.FetchReach, dict(sparse=True),
                           _fetch_reach_states, _fetch_actions),
    "fpp": (fetch.FetchPickAndPlace, jfetch.FetchPickAndPlace, dict(sparse=False),
            _fpp_states, _fetch_actions),
    "fpp_sparse_shaped": (fetch.FetchPickAndPlace, jfetch.FetchPickAndPlace,
                          dict(sparse=True, shaped_reward=True), _fpp_states, _fetch_actions),
    "fpp_dense_shaped": (fetch.FetchPickAndPlace, jfetch.FetchPickAndPlace,
                         dict(sparse=False, shaped_reward=True), _fpp_states, _fetch_actions),
    "door": (adroit.Door, jadroit.Door, dict(shaped_reward=False), _door_states, _hand_actions),
    "door_shaped_no_bonus": (adroit.Door, jadroit.Door,
                             dict(shaped_reward=True, add_bonus_rewards=False),
                             _door_states, _hand_actions),
    "relocate": (adroit.Relocate, jadroit.Relocate, {}, _relocate_states, _hand_actions),
}


def _case(name, P=64, seed=0):
    port_cls, jax_cls, kw, states, actions = ENVS[name]
    env, jenv = port_cls(**kw), jax_cls(**kw)
    rng = np.random.default_rng(seed)
    S = states(rng, P).astype(np.float32)
    A = actions(rng, P, env.action_dim).astype(np.float32)
    return env, jenv, S, A


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, **TOL)


@pytest.mark.parametrize("name", list(ENVS))
def test_step_matches_jax(name):
    """The population step against the JAX step, vmapped; one state's step
    against the batched one; the states reach the switches."""
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
    new = got[0].numpy()
    if name.startswith("fpp"):      # grasps, holds and releases all occur
        assert 0 < new[:, 10].sum() < len(new)
    if name.startswith("door"):     # some rows pull the door, some do not
        pulled = np.abs(new[:, 30:33] - (S[:, 30:33] + 0.025 * np.clip(A[:, :3], -1, 1)))
        assert (pulled.max(-1) > 1e-4).any() and (pulled.max(-1) < 1e-6).any()
    if name == "relocate":
        assert 0 < new[:, 36].sum() < len(new)


@pytest.mark.parametrize("name", list(ENVS))
def test_observation_cost_and_success_match_jax(name):
    """Observation of states, and cost and success over leading batch
    dimensions [2, P]."""
    env, jenv, S, A = _case(name, seed=1)
    _close(env.observation(torch.from_numpy(S)).numpy(), jax.vmap(jenv.observation)(S))
    S2 = _case(name, seed=2)[2]
    obs = np.stack([np.asarray(jax.vmap(jenv.observation)(x)) for x in (S, S2)])
    nxt = obs[::-1].copy()
    act = np.stack([A, A[::-1]])
    t = [torch.from_numpy(x) for x in (obs, act, nxt)]
    j = [jnp.asarray(x) for x in (obs, act, nxt)]
    _close(env.cost_fn(*t).numpy(), jenv.cost_fn(*j), "cost")
    _close(env.reward_fn(*t).numpy(), -np.asarray(jenv.cost_fn(*j)), "reward")
    success = env.is_success(*t)
    np.testing.assert_array_equal(success.numpy(), np.asarray(jenv.is_success(*j)))
    assert success.dtype == torch.float32 and 0 < float(success.sum()) < success.numel()


def test_door_cost_takes_every_bonus_tier():
    """The bonus tiers at door_pos > 0.2 / 1.0 / 1.35 on either side of each
    threshold, against the JAX cost; success at 1.35."""
    env, jenv = adroit.Door(shaped_reward=False), jadroit.Door(shaped_reward=False)
    obs = np.zeros((8, 39), np.float32)
    obs[:, 28] = [0.0, 0.19, 0.21, 0.99, 1.01, 1.34, 1.36, 1.6]
    cost = env.cost_fn(torch.from_numpy(obs), None, None).numpy()
    _close(cost, jenv.cost_fn(jnp.asarray(obs), None, None))
    # the rest of the cost: the distance to 1.57 and the velocity term
    # (door_pos lies in the last 30 entries)
    bonus = cost - 0.1 * (obs[:, 28] - 1.57) ** 2 - 1e-5 * obs[:, 28] ** 2
    np.testing.assert_allclose(bonus, [0, 0, -2, -2, -10, -10, -20, -20], atol=1e-5)
    np.testing.assert_array_equal(env.is_success(None, None, torch.from_numpy(obs)).numpy(),
                                  [0, 0, 0, 0, 0, 0, 1, 1])


def test_masked_goal_space_interface_matches_jax():
    """Goal and achieved-goal extraction, goal overwrite, the sparse and
    dense thresholded costs, the reward and success on the next observation."""
    rng = np.random.default_rng(3)
    obs = rng.normal(0.0, 0.1, (3, 5, 9)).astype(np.float32)
    goals = rng.normal(0.0, 0.1, (3, 5, 2)).astype(np.float32)
    for sparse in (False, True):
        kw = dict(goal_idx=[7, 2], achieved_goal_idx=[0, 5], sparse=sparse, threshold=0.12)
        env, jenv = base.MaskedGoalSpaceEnv(**kw), jbase.MaskedGoalSpaceEnv(**kw)
        t, j = torch.from_numpy(obs), jnp.asarray(obs)
        np.testing.assert_array_equal(env.goal_from_observation(t).numpy(),
                                      np.asarray(jenv.goal_from_observation(j)))
        np.testing.assert_array_equal(env.achieved_goal_from_observation(t).numpy(),
                                      np.asarray(jenv.achieved_goal_from_observation(j)))
        over = env.overwrite_goal(t, torch.from_numpy(goals))
        np.testing.assert_array_equal(over.numpy(),
                                      np.asarray(jenv.overwrite_goal(j, jnp.asarray(goals))))
        assert not torch.equal(over, t)  # a copy: the input is left alone
        _close(env.cost_fn(t, None, t).numpy(), jenv.cost_fn(j, None, j))
        _close(env.reward_fn(t, None, t).numpy(), jenv.reward_fn(j, None, j))
        succ = env.is_success(t, None, t.flip(0))
        np.testing.assert_array_equal(succ.numpy(), np.asarray(jenv.is_success(j, None, j[::-1])))
        assert 0 < float(succ.sum()) < succ.numel()
    with pytest.raises(ValueError, match="threshold"):
        base.MaskedGoalSpaceEnv(goal_idx=[0], achieved_goal_idx=[1], sparse=True, threshold=-1)


@pytest.mark.parametrize("cls,jcls,kw", [
    (fetch.FetchReach, jfetch.FetchReach, dict(sparse=False, fixed_goal=(0.05, -0.1, 0.02))),
    (fetch.FetchPickAndPlace, jfetch.FetchPickAndPlace,
     dict(sparse=False, fixed_goal=(0.5, -0.5, 0.4), fixed_object_pos=(-0.3, 0.6, 0.0))),
])
def test_fixed_scenes_match_jax(cls, jcls, kw):
    """With a fixed goal and object no draw is used: the same start state."""
    env, jenv = cls(**kw), jcls(**kw)
    _close(env.init_state(torch.Generator().manual_seed(0)).numpy(),
           jenv.init_state(jax.random.key(0)))


@pytest.mark.parametrize("name", ["FetchReach", "FetchPickAndPlace", "Door", "Relocate"])
def test_random_start_states_lie_in_the_jax_ranges(name):
    """The draws differ from the JAX package's (other generators), so the
    start states are held to the ranges the JAX envs draw from, with the
    start's fixed part equal to JAX's."""
    kw = {"Door": {}, "Relocate": {}}.get(name, dict(sparse=False))
    env = {"FetchReach": fetch.FetchReach, "FetchPickAndPlace": fetch.FetchPickAndPlace,
           "Door": adroit.Door, "Relocate": adroit.Relocate}[name](**kw)
    jenv = {"FetchReach": jfetch.FetchReach, "FetchPickAndPlace": jfetch.FetchPickAndPlace,
            "Door": jadroit.Door, "Relocate": jadroit.Relocate}[name](**kw)
    gen = torch.Generator().manual_seed(1)
    S = torch.stack([env.init_state(gen) for _ in range(200)]).numpy()
    J = np.stack([np.asarray(jenv.init_state(k)) for k in jax.random.split(jax.random.key(1), 8)])
    init = fetch.GRIPPER_INIT
    if name == "FetchReach":
        varying = slice(7, 10)
        assert np.all(np.abs(S[:, 7:10] - init) <= 0.15 + 1e-6)
    elif name == "FetchPickAndPlace":
        varying = np.r_[4:6, 11:14]
        ring = np.linalg.norm(S[:, 4:6] - init[:2], axis=1)
        assert ring.min() >= 0.1 - 1e-6 and ring.max() <= 0.15 + 1e-6
        goal_z = S[:, 13] - fetch.TABLE_HEIGHT - fetch.OBJ_HALF_HEIGHT
        assert np.all(np.abs(S[:, 11:13] - init[:2]) <= 0.15 + 1e-6)
        assert 0.3 < np.mean(goal_z > 1e-6) < 0.7 and goal_z.max() <= 0.45 + 1e-6
    elif name == "Door":
        varying = slice(33, 35)
        assert np.all(S[:, 33] >= -0.3 - 1e-6) and np.all(S[:, 33] <= 1e-6)
        assert np.all(np.abs(S[:, 34] + 0.25) <= 0.05 + 1e-6)
    else:
        varying = np.r_[30:32, 37:40]
        assert np.all(S[:, 30] >= -0.15) and np.all(S[:, 30] <= 0.15)
        assert np.all(S[:, 31] >= -0.15) and np.all(S[:, 31] <= 0.3)
        assert np.all(np.abs(S[:, 37:39]) <= 0.2) and np.all((S[:, 39] >= 0.15) & (S[:, 39] <= 0.35))
    fixed = np.ones(S.shape[1], bool)
    fixed[varying] = False
    np.testing.assert_array_equal(S[:, fixed], np.broadcast_to(J[0, fixed], S[:, fixed].shape))
    assert np.unique(S[:, ~fixed], axis=0).shape[0] == len(S)


@pytest.mark.parametrize("name", ["fetch_reach", "fpp", "door", "relocate"])
def test_ground_truth_rollouts_match_jax(name):
    """The ground-truth model's open-loop rollouts (the env's step, per
    control step) against the JAX package's over 4 steps."""
    env, jenv, S, _ = _case(name, P=8, seed=4)
    A = np.random.default_rng(5).uniform(-1, 1, (8, 4, env.action_dim)).astype(np.float32)
    St = torch.from_numpy(S)
    got = rollout_open_loop(GroundTruthModel(env=env).predict_fn, St, env.observation(St),
                            torch.from_numpy(A))
    jmodel = JaxGroundTruthModel(env=jenv)
    want = jax.jit(lambda s, o, a: jax_rollout_open_loop(jmodel.predict_fn, s, o, a))(
        jnp.asarray(S), jax.vmap(jenv.observation)(jnp.asarray(S)), jnp.asarray(A))
    for field in ("observations", "next_observations", "actions", "rewards"):
        _close(getattr(got, field).numpy(), getattr(want, field), field)


def test_ant3d_action_repeat_equals_raw_steps_and_jax():
    """Ant3D with action repeat 2: its step is two raw steps under one
    action with the rewards summed (one h = 1 launch of B2 per sub-step on
    the card), batched and single, and equals the JAX package's repeated
    population step; its whole-horizon rollout declines, so the ground-truth
    model steps the repeated env."""
    kw = dict(exclude_current_positions_from_observation=False)
    env, raw, jenv = Ant3D(action_repeat=2, **kw), Ant3D(**kw), JaxAnt3D(action_repeat=2, **kw)
    rng = np.random.default_rng(8)
    q = np.zeros((16, 14))
    q[:, 2], q[:, 7::2] = 0.48, 0.9
    q += rng.uniform(-0.1, 0.1, (16, 14)) * np.array([1, 1, 0.1, 0.1, 0.1, 0.3] + [1] * 8)
    S = np.concatenate([q, 0.05 * rng.standard_normal((16, 14))], axis=1).astype(np.float32)
    A = rng.uniform(-1, 1, (16, 8)).astype(np.float32)
    St, At = torch.from_numpy(S), torch.from_numpy(A)

    got = env.step_batched(St, At)
    s1, _, r1, _ = raw.step_batched(St, At)
    s2, o2, r2, _ = raw.step_batched(s1, At)
    # the repeat adds each sub-step as s + alive * (s' - s): roundoff of s
    np.testing.assert_allclose(got[0].numpy(), s2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), o2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), (r1 + r2).numpy(), rtol=1e-6)
    one = env.step(St[5], At[5])
    np.testing.assert_array_equal(one[0].numpy(), got[0][5].numpy())
    assert env.get_fps() == pytest.approx(10.0)

    want = jax.jit(jenv.step_batched)(jnp.asarray(S), jnp.asarray(A))
    # both run the row engine: float32 roundoff over two control steps,
    # held at the rule of tests/test_torch_spatial_physics.py::_step_case
    np.testing.assert_allclose(got[0][:, :14].numpy(), np.asarray(want[0])[:, :14], atol=1e-4)
    np.testing.assert_allclose(got[0][:, 14:].numpy(), np.asarray(want[0])[:, 14:], atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-3)

    assert env.rollout_batched(St, At[:, None].repeat(1, 3, 1)) is None
    traj = rollout_open_loop(GroundTruthModel(env=env).predict_fn, St, env.observation(St),
                             At[:, None].repeat(1, 2, 1))
    np.testing.assert_array_equal(traj.next_observations[0].numpy(), got[1].numpy())
