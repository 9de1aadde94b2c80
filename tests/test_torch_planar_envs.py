"""icem_torch's planar envs (Hopper, the reachers, the sagittal Ant and
humanoids, the swimmer, the dm-suite cheetah) against the JAX package's, on
identical states and actions made with numpy from a seed.

- observation, ``_post_step`` (reward, done), ``cost_fn``,
  ``state_from_observation`` and the unhealthy flags: the same float32
  operations, held at 1e-5;
- the population step's physics against the JAX env's step at P = 64, where
  it runs its row engine (``batched.step_batched``): 1e-4 on q and 1e-3 on
  qd, the row engines' rule (tests/test_torch_planar_physics.py);
- ``rollout_batched`` against the JAX env's at P = 64 over 3 control steps:
  1e-3, as for HalfCheetah (tests/test_torch_cheetah.py).
  Where the model itself turns a one-ulp change of the start positions into
  a larger gap than these, a gap within 4x of that one's is held instead,
  the rule of tests/test_torch_kernel_body.py: the Hopper (gear 200 on light
  links, qd up to its 50 rad/s rail) moves its own qd by 1.75e-3 in one step
  under a one-ulp change of q;
- ``convert.planar_model_from_arrays`` carries every field of each model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_torch.convert import planar_model_from_arrays
from icem_torch.envs import _ENV_REGISTRY, ant, dm_suite, env_from_string, hopper, humanoid, reacher
from icem_tpu.envs import _ENV_REGISTRY as _JAX_ENV_REGISTRY
from icem_tpu.envs import env_from_string as jax_env_from_string
from icem_tpu.envs import ant as jant
from icem_tpu.envs import dm_suite as jdm
from icem_tpu.envs import hopper as jhopper
from icem_tpu.envs import humanoid as jhumanoid
from icem_tpu.envs import reacher as jreacher

TOL = dict(rtol=1e-5, atol=1e-5)
FULL = dict(exclude_current_positions_from_observation=False)
EXCL = dict(exclude_current_positions_from_observation=True)

# name -> (port class, JAX class, kwargs)
ENVS = {
    "hopper": (hopper.Hopper, jhopper.Hopper, FULL),
    "hopper_excluding_x": (hopper.Hopper, jhopper.Hopper, EXCL),
    "reacher": (reacher.Reacher, jreacher.Reacher, {}),
    "reacher_suite": (reacher.ReacherSuite, jreacher.ReacherSuite, {}),
    "restricted_reacher": (reacher.RestrictedReacherSuite, jreacher.RestrictedReacherSuite, {}),
    "planar_ant": (ant.Ant, jant.Ant, FULL),
    "planar_ant_excluding_x": (ant.Ant, jant.Ant, EXCL),
    "planar_humanoid_standup": (humanoid.HumanoidStandup, jhumanoid.HumanoidStandup, {}),
    "planar_humanoid": (humanoid.Humanoid, jhumanoid.Humanoid, {}),
    "swimmer": (dm_suite.SwimmerSuite, jdm.SwimmerSuite, {}),
    "cheetah_suite": (dm_suite.HalfCheetahSuite, jdm.HalfCheetahSuite, {}),
}
# one env per planar model, for the physics
MODELS = ("hopper", "reacher", "planar_ant", "planar_humanoid", "swimmer")


def _envs(name):
    port_cls, jax_cls, kw = ENVS[name]
    return port_cls(**kw), jax_cls(**kw)


def _states(env, P, seed):
    """States around the model's stance: q in +-0.4 (the root height offset
    in [-0.8, 0.3], so that some states leave the healthy bands), qd of std
    0.5, and the extra state (targets) in +-0.2."""
    rng = np.random.default_rng(seed)
    nd = env.model.ndof
    q = rng.uniform(-0.4, 0.4, (P, nd))
    if env.model.free_root:
        q[:, 1] = rng.uniform(-0.8, 0.3, P)
    qd = 0.5 * rng.standard_normal((P, nd))
    width = env.init_state(torch.Generator().manual_seed(0)).shape[0]
    extra = rng.uniform(-0.2, 0.2, (P, width - 2 * nd))
    return np.concatenate([q, qd, extra], axis=1).astype(np.float32)


def _physics_states(env, P, seed):
    """States near the stance, as tests/test_torch_planar_physics.py makes
    them (q of std 0.05, qd of std 0.1): the wide states above drive feet
    deep into the ground, where the capped contacts rail qd at max_qd and
    float32 roundoff between two operation orders grows past 1e-3."""
    rng = np.random.default_rng(seed)
    nd = env.model.ndof
    S = _states(env, P, seed)
    S[:, :nd] = 0.05 * rng.standard_normal((P, nd))
    S[:, nd:2 * nd] = 0.1 * rng.standard_normal((P, nd))
    return S


def _actions(env, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, tuple(shape) + (env.action_dim,)).astype(np.float32)


def _one_ulp(S, nd):
    """S with its positions moved one ulp up."""
    S = S.copy()
    S[:, :nd] = np.nextafter(S[:, :nd], np.float32(np.inf))
    return S


def _held(got, want, ulp, atol, msg):
    """max |got - want| under atol, or under 4x the gap that a one-ulp
    change of the start positions opens in the port itself (``ulp``)."""
    gap = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    own = float(np.abs(np.asarray(got) - np.asarray(ulp)).max())
    assert gap < max(atol, 4 * own), f"{msg}: gap {gap:.3e}, one-ulp gap {own:.3e}"


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, **(tol or TOL))


@pytest.mark.parametrize("name", list(ENVS))
def test_observation_post_step_and_cost_match_jax(name):
    env, jenv = _envs(name)
    P = 64
    S, S2 = _states(env, P, 0), _states(env, P, 1)
    A = np.clip(_actions(env, (P,), 2), -1.0, 1.0)  # _post_step takes clipped actions
    obs = env.observation(torch.from_numpy(S))
    nxt = env.observation(torch.from_numpy(S2))
    assert tuple(obs.shape) == (P, env.obs_dim)
    _close(obs.numpy(), jenv.observation(jnp.asarray(S)), "observation")
    # over [h, P] leading dims, as the rollout calls it
    _close(env.observation(torch.from_numpy(S).reshape(4, 16, -1)).reshape(P, -1).numpy(),
           obs.numpy(), "observation over two leading dims")

    got = env._post_step(torch.from_numpy(S), torch.from_numpy(S2), torch.from_numpy(A))
    want = jax.vmap(jenv._post_step)(jnp.asarray(S), jnp.asarray(S2), jnp.asarray(A))
    for field, g, w in zip(("obs", "reward", "done"), got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), field
        _close(g.numpy(), w, f"_post_step {field}")

    jobs, jnxt = jnp.asarray(obs.numpy()), jnp.asarray(nxt.numpy())
    if name.endswith("excluding_x"):
        # the cost reads the position: both packages refuse the short obs
        with pytest.raises(AttributeError):
            env.cost_fn(obs, torch.from_numpy(A), nxt)
        with pytest.raises(AttributeError):
            jenv.cost_fn(jobs, jnp.asarray(A), jnxt)
    else:
        _close(env.cost_fn(obs, torch.from_numpy(A), nxt).numpy(),
               jenv.cost_fn(jobs, jnp.asarray(A), jnxt), "cost_fn")
    if env.supports_state_from_obs:
        _close(env.state_from_observation(obs).numpy(), jenv.state_from_observation(jobs),
               "state_from_observation")
    else:
        assert not jenv.supports_state_from_obs


@pytest.mark.parametrize("name, method", [("hopper", "unhealthy_states"),
                                          ("planar_ant", "are_states_unhealthy"),
                                          ("planar_humanoid", "unhealthy_states")])
def test_unhealthy_flags_match_jax(name, method):
    env, jenv = _envs(name)
    obs = env.observation(torch.from_numpy(_states(env, 64, 3))).numpy()
    obs[5, 4] = np.nan
    obs[9, 0] = np.inf
    got = getattr(env, method)(torch.from_numpy(obs)).numpy()
    want = np.asarray(getattr(jenv, method)(jnp.asarray(obs)))
    np.testing.assert_array_equal(got, want)
    assert got[5] == got[9] == 1.0 and 0 < got.sum() < 64


@pytest.mark.parametrize("name", MODELS)
def test_step_batched_physics_matches_jax(name):
    """The population step (the plain version here) against the JAX env's
    population step, and one trajectory's step against its row."""
    env, jenv = _envs(name)
    P = 64
    S = _physics_states(env, P, 4)
    A = _actions(env, (P,), 5)
    nd = env.model.ndof
    new, obs, rew, done = env.step_batched(torch.from_numpy(S), torch.from_numpy(A))
    ulp = env.step_batched(torch.from_numpy(_one_ulp(S, nd)), torch.from_numpy(A))[0]
    jnew = np.asarray(jax.jit(jenv.step_batched)(jnp.asarray(S), jnp.asarray(A))[0])
    _held(new[:, :nd], jnew[:, :nd], ulp[:, :nd], 1e-4, "q")
    _held(new[:, nd:2 * nd], jnew[:, nd:2 * nd], ulp[:, nd:2 * nd], 1e-3, "qd")
    np.testing.assert_array_equal(new[:, 2 * nd:].numpy(), S[:, 2 * nd:])
    one = env.step(torch.from_numpy(S[7]), torch.from_numpy(A[7]))
    for field, g, w in zip(("state", "obs", "reward", "done"), one, (new, obs, rew, done)):
        _close(g.numpy(), w[7].numpy(), field, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_rollout_batched_matches_jax(name):
    env, jenv = _envs(name)
    P, h = 64, 3
    S = _physics_states(env, P, 6)
    A = _actions(env, (P, h), 7)
    got = env.rollout_batched(torch.from_numpy(S), torch.from_numpy(A))
    ulp = env.rollout_batched(torch.from_numpy(_one_ulp(S, env.model.ndof)),
                              torch.from_numpy(A))
    want = jax.jit(jenv.rollout_batched)(jnp.asarray(S), jnp.asarray(A))
    names = ("obs_seq", "next_obs_seq", "actions_tm", "rewards", "final_states")
    for field, g, u, w in zip(names, got, ulp, want):
        assert tuple(g.shape) == tuple(w.shape), field
        _held(g, w, u, 1e-3, field)
    assert float(got[2].abs().max()) <= 1.0


@pytest.mark.parametrize("name", MODELS)
def test_convert_carries_every_field(name):
    """The JAX model through ``planar_model_from_arrays`` is the port's own
    model, field for field."""
    env, jenv = _envs(name)
    jm, ours = jenv.model, env.model
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in dataclasses.asdict(jm).items()}
    carried = planar_model_from_arrays(fields)
    for f in dataclasses.fields(carried):
        a, b, c = getattr(carried, f.name), getattr(ours, f.name), getattr(jm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.float32, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            np.testing.assert_array_equal(a, np.asarray(c, np.float32), err_msg=f.name)
        else:
            assert a == b == c, f.name
    assert (carried.nbody, carried.ndof) == (jm.nbody, jm.ndof)


@pytest.mark.parametrize("name", list(ENVS))
def test_spaces_and_init_state_match_jax(name):
    """Spaces, dt and the kernel shape as in the JAX package; the start
    states (other PRNG streams) inside the JAX package's support."""
    env, jenv = _envs(name)
    assert (env.obs_dim, env.action_dim, env.dt) == (jenv.obs_dim, jenv.action_dim, jenv.dt)
    np.testing.assert_array_equal(env.action_space.low, jenv.action_space.low)
    assert env.supports_state_from_obs == jenv.supports_state_from_obs
    assert (env.model.n_substeps, env.model.dt) == (jenv.model.n_substeps, jenv.model.dt)
    gen = torch.Generator().manual_seed(0)
    ours = torch.stack([env.init_state(gen) for _ in range(64)]).numpy()
    theirs = np.stack([np.asarray(jenv.init_state(k))
                       for k in jax.random.split(jax.random.key(0), 64)])
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    spread = np.ptp(theirs, 0)
    # a normal draw's tail reaches past the 64 JAX draws' range
    assert np.all(ours.min(0) >= theirs.min(0) - spread - 1e-6)
    assert np.all(ours.max(0) <= theirs.max(0) + spread + 1e-6)


def test_frame_skip_sets_the_substeps_as_in_jax():
    for cls, jcls in ((hopper.Hopper, jhopper.Hopper), (ant.Ant, jant.Ant),
                      (humanoid.Humanoid, jhumanoid.Humanoid)):
        assert cls(frame_skip=2).model.n_substeps == jcls(frame_skip=2).model.n_substeps


def test_registry_resolves_21_strings_to_the_jax_class_names():
    """The port resolves all 25 of the JAX package's registry strings (21
    before the Fetch and Adroit envs were ported), each to a class of the
    JAX one's name; any other string raises."""
    assert len(_JAX_ENV_REGISTRY) == 25 and len(_ENV_REGISTRY) == 25
    assert set(_ENV_REGISTRY) == set(_JAX_ENV_REGISTRY)
    # the Fetch envs take their sparse flag from the settings files
    needs = {"FetchReach": dict(sparse=False), "FetchPickAndPlace": dict(sparse=False)}
    for name in _ENV_REGISTRY:
        env = env_from_string(name, **needs.get(name, {}))
        assert type(env).__name__ == _JAX_ENV_REGISTRY[name][1], name
        assert env.name == name
    for name in ("PlanarAnt", "Hopper", "swimmer", "Door", "Relocate"):
        jenv = jax_env_from_string(name)
        assert env_from_string(name).obs_dim == jenv.obs_dim
    with pytest.raises(ImportError, match="known: "):
        env_from_string("NoSuchEnv")
