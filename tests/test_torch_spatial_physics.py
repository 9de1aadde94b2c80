"""icem_torch's spatial row engine against the JAX package's batched spatial
engine, and the port's real Ant3D step against the JAX autodiff engine.

The JAX models are carried over with ``convert.spatial_model_from_arrays``,
so both packages compute from identical constants; identical states and
controls are made with numpy from a seed. Covered: Ant3D (free root, scalar
max_qd, identity chart), Humanoid3D with the chart recentred by -pi/4
(per-dof max_qd, the motor speed line) and a three-link hinge-root chain with
skew axes. Tolerances are the ones tests/test_spatial_batched.py holds the
JAX batched engine to against the autodiff engine.

The JAX Humanoid step compiles for many minutes on the CPU, so its jitted
comparison is marked slow; tier-1 holds the same 23-dof step against the
JAX step run eagerly under ``jax.disable_jit()`` (about 15 s in each precision),
beside its pieces here and the g++ build of the kernel body
(tests/test_torch_spatial_kernel_body.py).
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs.ant3d import Ant3D as JaxAnt3D
from icem_tpu.envs.ant3d import make_ant3d_model as jax_ant3d_model
from icem_tpu.envs.humanoid3d import make_humanoid3d_model as jax_humanoid3d_model
from icem_tpu.envs.physics import spatial_batched as jsb
from icem_tpu.envs.physics.spatial import SpatialModel as JaxSpatialModel
from icem_torch.convert import spatial_model_from_arrays
from icem_torch.envs.ant3d import Ant3D, make_ant3d_model
from icem_torch.envs.humanoid3d import make_humanoid3d_model
from icem_torch.envs.physics import spatial_batched as tsb


def _hinge_tree_model():
    """tests/test_spatial_batched.py's 3-link hinge-root chain with skew axes."""
    ax1 = np.array([0.6, 0.0, 0.8])
    ax2 = np.array([0.0, 1.0, 0.0])
    return JaxSpatialModel(
        parent=(-1, 0, 1),
        anchor=np.array([[0.0, 0.0, 1.5], [0.4, 0.0, 0.0], [0.4, 0.1, 0.0]], np.float32),
        axis=np.stack([ax1, ax2, ax1]).astype(np.float32),
        com=np.array([[0.2, 0.0, 0.0]] * 3, np.float32),
        mass=np.array([1.0, 0.7, 0.4], np.float32),
        inertia=np.array([[0.02, 0.03, 0.02]] * 3, np.float32),
        free_root=False,
        geom_body=(2,),
        geom_pos=np.array([[0.4, 0.0, 0.0]], np.float32),
        geom_radius=np.array([0.05], np.float32),
        actuator_dof=(0, 1, 2),
        gear=np.array([10.0, 8.0, 5.0], np.float32),
        damping=np.array([0.5, 0.3, 0.2], np.float32),
        stiffness=np.array([2.0, 1.0, 0.0], np.float32),
        springref=np.array([0.1, 0.0, 0.0], np.float32),
        limit_lo=np.array([-1.2, -np.inf, -2.0], np.float32),
        limit_hi=np.array([1.2, np.inf, 2.0], np.float32),
        dt=0.02,
        n_substeps=4,
    )


MODELS = {
    "ant3d": jax_ant3d_model,
    "humanoid3d": lambda: jax_humanoid3d_model(chart_center_pitch=-np.pi / 4),
    "hinge_tree": _hinge_tree_model,
}


@lru_cache(maxsize=None)
def _models(name):
    jm = MODELS[name]()
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in dataclasses.asdict(jm).items()}
    return jm, spatial_model_from_arrays(fields)


def _states(model, P, seed, spread=0.5):
    """tests/test_spatial_batched.py's state distribution, made with numpy."""
    rng = np.random.default_rng(seed)
    n = model.ndof
    q = spread * rng.standard_normal((P, n))
    if model.free_root:
        q[:, 2] += 0.8          # keep the tree near (partial) contact
        q[:, 4] *= 0.3          # stay away from the chart singularity
    qd = spread * rng.standard_normal((P, n))
    return q.astype(np.float32), qd.astype(np.float32)


def _arr(rows, P):
    """Rows (tensors, JAX arrays or constant floats) -> [P, len(rows)]."""
    return np.stack([np.broadcast_to(np.asarray(r, np.float32), (P,)) for r in rows], -1)


def _both(jm, tm, fn, Q, QD):
    """fn(module, model, q rows, qd rows) through JAX (jitted) and torch."""
    jout = jax.jit(lambda a, b: fn(jsb, jm, list(a.T), list(b.T)))(jnp.asarray(Q),
                                                                   jnp.asarray(QD))
    tout = fn(tsb, tm, list(torch.from_numpy(Q).T), list(torch.from_numpy(QD).T))
    return jout, tout


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fk_rows_matches_jax(name):
    jm, tm = _models(name)
    P = 8
    Q, QD = _states(tm, P, seed=0)
    jfk, tfk = _both(jm, tm, lambda mod, m, q, qd: mod.fk_rows(m, q), Q, QD)
    jo, jR, jax_axes, jc, jg = jfk
    to, tR, t_axes, tc, tg = tfk
    for b in range(tm.nbody):
        np.testing.assert_allclose(_arr(to[b], P), _arr(jo[b], P), atol=1e-5)
        np.testing.assert_allclose(_arr(tc[b], P), _arr(jc[b], P), atol=1e-5)
        for i in range(3):
            np.testing.assert_allclose(_arr(tR[b][i], P), _arr(jR[b][i], P), atol=1e-5)
    for j in range(tm.ndof):
        assert (t_axes[j] is None) == (jax_axes[j] is None)
        if t_axes[j] is not None:
            for part in range(2):
                np.testing.assert_allclose(_arr(t_axes[j][part], P),
                                           _arr(jax_axes[j][part], P), atol=1e-5)
    for g in range(len(tm.geom_body)):
        np.testing.assert_allclose(_arr(tg[g], P), _arr(jg[g], P), atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mass_bias_matches_jax(name):
    jm, tm = _models(name)
    P = 8
    Q, QD = _states(tm, P, seed=1)
    (jM, jb), (tM, tb) = _both(jm, tm, lambda mod, m, q, qd: mod.mass_bias_rows(m, q, qd),
                               Q, QD)
    n = tm.ndof
    M_t = np.stack([_arr(tM[i], P) for i in range(n)], -2)
    M_j = np.stack([_arr(jM[i], P) for i in range(n)], -2)
    scale = max(1.0, float(np.abs(M_j).max()))
    bscale = max(1.0, float(np.abs(_arr(jb, P)).max()))
    np.testing.assert_allclose(M_t, M_j, atol=3e-5 * scale)
    np.testing.assert_allclose(_arr(tb, P), _arr(jb, P), atol=3e-4 * bscale)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_contact_tau_matches_jax(name):
    jm, tm = _models(name)
    P = 8
    Q, QD = _states(tm, P, seed=2)
    if tm.free_root:
        Q[:, 2] -= 0.6          # force real penetration for some rows

    def contact(mod, m, q, qd):
        return mod.contact_tau_rows(m, qd, mod.fk_rows(m, q), mod.rot_chains(m))

    jtau, ttau = _both(jm, tm, contact, Q, QD)
    scale = max(1.0, float(np.abs(_arr(jtau, P)).max()))
    np.testing.assert_allclose(_arr(ttau, P), _arr(jtau, P), atol=3e-4 * scale)
    if tm.free_root:
        assert np.abs(_arr(jtau, P)).max() > 0.0, "no row in contact"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_energies_match_jax(name):
    jm, tm = _models(name)
    P = 8
    Q, QD = _states(tm, P, seed=3)

    def energies(mod, m, q, qd):
        fk, chains = mod.fk_rows(m, q), mod.rot_chains(m)
        return (mod.kinetic_rows(m, qd, fk, chains),
                mod.stored_energy_rows(m, q, qd, fk, chains))

    (jke, jse), (tke, tse) = _both(jm, tm, energies, Q, QD)
    for t, j in ((tke, jke), (tse, jse)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=2e-4 * max(1.0, float(np.abs(j).max())))


def test_rot_chains_and_per_dof_tables_match_jax():
    for name in MODELS:
        jm, tm = _models(name)
        assert tsb.rot_chains(tm) == jsb.rot_chains(jm)
        for arr, fill in (("limit_lo", -np.inf), ("stiffness", 0.0), ("damping", 0.0)):
            np.testing.assert_array_equal(tsb._per_dof_np(tm, getattr(tm, arr), fill),
                                          jsb._per_dof_np(jm, getattr(jm, arr), fill))


def _step_case(jm, tm, Q, QD, C):
    """One control step of both row engines (the same algorithm), held at
    the planar rule: 1e-4 on q, 1e-3 on qd. The gaps at ant3d are about
    1e-6 on q and 4e-5 on qd, at |qd| up to 12."""
    jq, jqd = jax.jit(lambda a, b, c: jsb.step_batched(jm, a, b, c))(
        jnp.asarray(Q), jnp.asarray(QD), jnp.asarray(C))
    tq, tqd = tsb.step_batched(tm, *map(torch.from_numpy, (Q, QD, C)))
    assert tq.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=1e-3)
    return tqd


def _controls(model, P):
    return np.random.default_rng(5).uniform(-1, 1, (P, len(model.actuator_dof))).astype(np.float32)


@pytest.mark.parametrize("name", ["ant3d", "hinge_tree"])
def test_step_rows_matches_jax(name):
    jm, tm = _models(name)
    Q, QD = _states(tm, 16, seed=4, spread=0.3)
    _step_case(jm, tm, Q, QD, _controls(tm, 16))


def test_energy_valve_fires_identically():
    """The valve rescales velocities only where the integrator gains energy,
    which random states rarely show in one step. Ant3D in free flight, with
    the valve's margin set to minus the median energy loss of a step, has
    the valve rescale about half the rows: both engines agree on them."""
    jm, tm = _models("ant3d")
    Q, QD = _states(tm, 16, seed=6, spread=0.3)
    Q[:, 2] += 1.0
    C = _controls(tm, 16)
    q, qd, c = (list(torch.from_numpy(x).T) for x in (Q, QD, C))
    chains = tsb.rot_chains(tm)
    free = dataclasses.replace(tm, energy_valve=False)
    q1, qd1 = tsb.step_rows(free, q, qd, c, chains)
    e0 = tsb.stored_energy_rows(tm, q, qd, tsb.fk_rows(tm, q), chains)
    e1 = tsb.stored_energy_rows(tm, q1, qd1, tsb.fk_rows(tm, q1), chains)
    eps = -float(np.median((e0 - e1).numpy()))
    jm, tm = (dataclasses.replace(m, energy_valve_eps=eps) for m in (jm, tm))
    tqd = _step_case(jm, tm, Q, QD, C)
    ratio = tqd.abs().sum(1) / torch.stack(qd1, 1).abs().sum(1)
    assert int((ratio < 0.999).sum()) >= 4, ratio


@pytest.mark.slow
def test_step_rows_matches_jax_humanoid():
    jm, tm = _models("humanoid3d")
    Q, QD = _states(tm, 16, seed=4, spread=0.3)
    _step_case(jm, tm, Q, QD, _controls(tm, 16))


def _eager_steps(jm, tm, *arrays):
    """One control step of both row engines on the same numpy arrays, the
    JAX one op by op (no program compile): ((jq, jqd), (tq, tqd))."""
    with jax.disable_jit():
        want = jsb.step_batched(jm, *map(jnp.asarray, arrays))
    want = tuple(map(np.asarray, want))
    got = tuple(x.numpy() for x in tsb.step_batched(tm, *map(torch.from_numpy, arrays)))
    assert got[0].dtype == want[0].dtype == arrays[0].dtype
    return want, got


def test_step_rows_matches_eager_jax_humanoid():
    """The 23-dof step (Humanoid3D, chart recentred by -pi/4, per-dof
    max_qd, the motor speed line, the valve) against the JAX batched step
    run eagerly: the inputs and the tolerance (1e-4 on q, 1e-3 on qd) of
    test_step_rows_matches_jax_humanoid, without its compile.

    q and qd are held in float64, where both engines compute the same
    algorithm and roundoff can neither hide a difference nor make one; q
    also in float32. float32 qd cannot be held on these draws: the two
    packages' sin and cos differ by an ulp on a few per cent of arguments,
    and rows 6 and 13 (at the max_qd clip) turn single ulps of q into up to
    9.4e-3 and 2.0e-3 of the port's own qd. The JAX package's own float32
    qd on row 6 is 5.8e-3 from its float64 step."""
    jm, tm = _models("humanoid3d")
    Q, QD = _states(tm, 16, seed=4, spread=0.3)
    C = _controls(tm, 16)
    with jax.enable_x64(True):
        want, got = _eager_steps(jm, tm, *(x.astype(np.float64) for x in (Q, QD, C)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    want, got = _eager_steps(jm, tm, Q, QD, C)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def test_real_ant_step_matches_jax_autodiff_step():
    """The port's real step (B2's plain version at P = 1, h = 1) against the
    JAX real step, which runs the autodiff engine; held at the tolerance
    tests/test_spatial_batched.py accepts between the two JAX engines."""
    kw = dict(exclude_current_positions_from_observation=False)
    jenv, env = JaxAnt3D(**kw), Ant3D(**kw)
    P = 4
    keys = jax.random.split(jax.random.key(7), P)
    S = np.asarray(jax.vmap(jenv.init_state)(keys))
    A = np.random.default_rng(8).uniform(-1, 1, (P, 8)).astype(np.float32)
    js, jobs, jrew, jdone = jax.jit(jax.vmap(jenv.step))(jnp.asarray(S), jnp.asarray(A))
    for p in range(P):
        s, obs, rew, done = env.step(torch.from_numpy(S[p]), torch.from_numpy(A[p]))
        assert tuple(s.shape) == (28,) and tuple(obs.shape) == (28,)
        np.testing.assert_allclose(s[:14].numpy(), np.asarray(js[p, :14]), atol=2e-3)
        np.testing.assert_allclose(s[14:].numpy(), np.asarray(js[p, 14:]), atol=8e-2)
        np.testing.assert_allclose(float(rew), float(jrew[p]), atol=2e-3 / env.dt)
        assert float(done) == float(jdone[p])


def test_convert_carries_every_field():
    jm, tm = _models("humanoid3d")
    ours = make_humanoid3d_model(chart_center_pitch=-np.pi / 4)
    for f in dataclasses.fields(tm):
        a, b, c = getattr(tm, f.name), getattr(ours, f.name), getattr(jm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.float32, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            np.testing.assert_array_equal(a, c, err_msg=f.name)
        else:
            assert a == b == c, f.name
    assert (tm.nbody, tm.ndof, tm.dof_of_body(3)) == (18, 23, 8)
    # a scalar max_qd stays a float
    _, ant = _models("ant3d")
    assert isinstance(ant.max_qd, float) and ant.max_qd == make_ant3d_model().max_qd
    with pytest.raises(ValueError, match="unknown SpatialModel fields"):
        spatial_model_from_arrays({**dataclasses.asdict(jm), "bogus": 1})
