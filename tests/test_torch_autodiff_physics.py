"""icem_torch's autodiff engines (``envs/physics/planar.py``, ``spatial.py``)
against the JAX package's, on identical models, states and controls made
with numpy from a seed.

The port takes the same derivatives with ``torch.func`` (jvp, jacfwd(grad),
vjp) and batches with ``torch.func.vmap``; the JAX side is jitted once per
function and model. Single evaluations are held at 1e-5 absolute plus 1e-5
relative to the largest entry of the result (a generalized force is a sum
of virtual-work terms whose size the largest entry carries). One control
step, from states off a contact or limit switch, is held at 1e-4 on q and
1e-3 on qd. The Humanoid3D is held against JAX at the single-evaluation
level only (its JAX step compiles for many minutes on a CPU); its whole
autodiff step is held against the port's row engine.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs.ant3d import make_ant3d_model as jax_ant3d_model
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_tpu.envs.cheetah import make_cheetah_model as jax_cheetah_model
from icem_tpu.envs.dm_suite import make_swimmer_model
from icem_tpu.envs.hopper import make_hopper_model
from icem_tpu.envs.humanoid3d import make_humanoid3d_model as jax_humanoid3d_model
from icem_tpu.envs.physics import planar as jp
from icem_tpu.envs.physics import spatial as js
from icem_tpu.envs.reacher import make_arm_model
from icem_torch.convert import planar_model_from_arrays, spatial_model_from_arrays
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.envs.physics import planar as tp
from icem_torch.envs.physics import spatial as ts
from icem_torch.ops.planar_rollout import rollout_planar_reference
from icem_torch.ops.spatial_rollout import rollout_spatial_reference

PLANAR = {
    "halfcheetah": lambda: jax_cheetah_model(dt=0.05, n_substeps=20),
    "hopper": lambda: make_hopper_model(dt=0.05, n_substeps=20),
    # fluid drag, no geoms
    "swimmer": lambda: make_swimmer_model(),
    # Reacher's arm: hinge root, no geoms (l1, l2, dt, substeps, torque, damping)
    "arm": lambda: make_arm_model(0.1, 0.11, 0.02, 4, 0.05, 0.01),
}
SPATIAL = {
    "ant3d": jax_ant3d_model,
    "humanoid3d": lambda: jax_humanoid3d_model(chart_center_pitch=-np.pi / 4),
}
P = 4


@lru_cache(maxsize=None)
def _models(name):
    """(JAX model, the port's model with the same fields)."""
    jm = {**PLANAR, **SPATIAL}[name]()
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in dataclasses.asdict(jm).items()}
    convert = spatial_model_from_arrays if name in SPATIAL else planar_model_from_arrays
    return jm, convert(fields)


def _inputs(model, seed, spread=0.3):
    """P states near (partial) ground contact and controls in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = model.ndof
    q = spread * rng.standard_normal((P, n))
    if model.free_root:
        spatial = isinstance(model, ts.SpatialModel)
        q[:, 2 if spatial else 1] += 0.7
        if spatial:
            q[:, 4] *= 0.3          # away from the chart singularity
    qd = spread * rng.standard_normal((P, n))
    a = rng.uniform(-1, 1, (P, len(model.actuator_dof)))
    return q.astype(np.float32), qd.astype(np.float32), a.astype(np.float32)


def _both(name, jfn, tfn, *args):
    """fn(model, *per-trajectory args) over P trajectories: JAX jit(vmap),
    the port's torch.func.vmap. Returns lists of numpy arrays."""
    jm, tm = _models(name)
    want = jax.jit(jax.vmap(lambda *a: jfn(jm, *a)))(*map(jnp.asarray, args))
    got = torch.func.vmap(lambda *a: tfn(tm, *a))(*map(torch.from_numpy, args))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want)
    return got, want


def _close(got, want, what):
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + 1e-5 * scale, err_msg=what)


EVALS = ("fk", "kinetic_energy", "potential_energy", "mass_matrix", "bias_forces",
         "contact_forces", "spring_forces", "damping_diagonal", "stored_energy")
STATE_ONLY = ("fk", "potential_energy", "mass_matrix", "spring_forces", "damping_diagonal")


@pytest.mark.parametrize("fn", EVALS + ("fluid_drag_forces", "actuation"))
@pytest.mark.parametrize("name", list(PLANAR))
def test_planar_single_evaluations_match_jax(name, fn):
    q, qd, a = _inputs(_models(name)[1], seed=1)
    args = (q,) if fn in STATE_ONLY else (a,) if fn == "actuation" else (q, qd)
    _close(*_both(name, getattr(jp, fn), getattr(tp, fn), *args), f"{name}.{fn}")


@pytest.mark.parametrize("fn", EVALS + ("actuation",))
@pytest.mark.parametrize("name", list(SPATIAL))
def test_spatial_single_evaluations_match_jax(name, fn):
    q, qd, a = _inputs(_models(name)[1], seed=2)
    args = (q,) if fn in STATE_ONLY else (a,) if fn == "actuation" else (q, qd)
    _close(*_both(name, getattr(js, fn), getattr(ts, fn), *args), f"{name}.{fn}")


@pytest.mark.parametrize("name", ["halfcheetah", "swimmer"])
def test_substep_matches_jax(name):
    """The one-substep integrator with a fresh mass matrix and a dense solve
    (the JAX package keeps it beside the control step, which holds M). A
    solve, like a step, carries the mass matrix's conditioning into its
    roundoff (the swimmer's light links): held as a step, 1e-4 on q and
    1e-3 on qd."""
    jm, tm = _models(name)
    q, qd, a = _inputs(tm, seed=12)
    dt_sub = tm.dt / tm.n_substeps
    tau = np.random.default_rng(13).uniform(-1, 1, (P, tm.ndof)).astype(np.float32)
    got, want = _both(name, lambda m, *x: jp.substep(m, *x, dt_sub),
                      lambda m, *x: tp.substep(m, *x, dt_sub), q, qd, tau)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4, err_msg=f"{name} q")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3, err_msg=f"{name} qd")


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(3)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    theta, rpy = np.float32(0.7), rng.standard_normal(3).astype(np.float32)
    _close([ts._rot_axis(axis, torch.tensor(theta)).numpy()],
           [np.asarray(js._rot_axis(axis, jnp.float32(theta)))], "_rot_axis")
    _close([ts._rot_rpy(torch.from_numpy(rpy)).numpy()],
           [np.asarray(js._rot_rpy(jnp.asarray(rpy)))], "_rot_rpy")
    A = rng.standard_normal((5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(ts._unhat(torch.from_numpy(A)).numpy(),
                                  np.asarray(js._unhat(jnp.asarray(A))))


def test_cholesky_matches_jax_and_keeps_the_relative_pivot_floor():
    rng = np.random.default_rng(4)
    B = rng.standard_normal((6, 6))
    A = (B @ B.T + 6 * np.eye(6)).astype(np.float32)
    A[5] = A[4]                   # singular: the last pivot meets the floor
    A[:, 5] = A[:, 4]
    b = rng.standard_normal(6).astype(np.float32)
    jL = jp.cholesky_unrolled(jnp.asarray(A), 6)
    tL = tp.cholesky_unrolled(torch.from_numpy(A), 6)
    assert float(tL[5][5]) == pytest.approx(float(np.sqrt(1e-5 * A[5, 5])), rel=1e-3)
    _close([tp.cholesky_solve_unrolled(tL, torch.from_numpy(b), 6).numpy()],
           [np.asarray(jp.cholesky_solve_unrolled(jL, jnp.asarray(b), 6))], "solve")


def _step_tolerance(tm, step, q, qd, a):
    """(q, qd) tolerances of one control step: 1e-4 / 1e-3, or, for a
    trajectory that turns a one-ulp change of its start state into more
    (the Hopper's limit and contact switches), 4x its own one-ulp gap."""
    q1, qd1 = step(q, qd, a)[:2]
    q2, qd2 = step(torch.nextafter(q, torch.full_like(q, np.inf)), qd, a)[:2]
    gap_q = float((q1 - q2).abs().max())
    gap_qd = float((qd1 - qd2).abs().max())
    return max(1e-4, 4 * gap_q), max(1e-3, 4 * gap_qd)


def _step_case(name, jfn, tfn, seed):
    jm, tm = _models(name)
    q, qd, a = _inputs(tm, seed)
    got, want = _both(name, jfn, tfn, q, qd, a)
    step = torch.func.vmap(lambda *x: tfn(tm, *x))
    tol_q, tol_qd = _step_tolerance(tm, step, *map(torch.from_numpy, (q, qd, a)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol_q, err_msg=f"{name} q")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol_qd, err_msg=f"{name} qd")
    return got, want


@pytest.mark.parametrize("name", list(PLANAR))
def test_planar_step_matches_jax(name):
    _step_case(name, jp.step, tp.step, seed=5)


@pytest.mark.parametrize("name", ["halfcheetah", "hopper"])
def test_step_with_energy_audit_matches_jax(name):
    got, want = _step_case(name, jp.step_with_energy_audit, tp.step_with_energy_audit,
                           seed=6)
    # the discrete actuator work sum(tau . qd' dt) over the substeps
    _close(got[2:], want[2:], f"{name} work")


def test_planar_valve_matches_jax_where_it_fires():
    """The planar energy valve (a model with energy_valve=True): with its
    margin set below the median energy change of a step, it rescales the
    end-of-step velocities of about half the trajectories, identically in
    both engines."""
    jm, tm = _models("halfcheetah")
    q, qd, a = _inputs(tm, seed=7)
    step = torch.func.vmap(lambda *x: tp.step_with_energy_audit(tm, *x))
    energy = torch.func.vmap(lambda *x: tp.stored_energy(tm, *x))
    tq, tqd, ta = map(torch.from_numpy, (q, qd, a))
    q1, qd1, w = step(tq, tqd, ta)
    gain = energy(q1, qd1) - energy(tq, tqd) - torch.clamp(w, min=0.0)
    eps = float(torch.median(gain))
    jv, tv = (dataclasses.replace(m, energy_valve=True, energy_valve_eps=eps)
              for m in (jm, tm))
    want = jax.jit(jax.vmap(lambda *x: jp.step(jv, *x)))(*map(jnp.asarray, (q, qd, a)))
    got = torch.func.vmap(lambda *x: tp.step(tv, *x))(tq, tqd, ta)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    ratio = got[1].abs().sum(1) / qd1.abs().sum(1)
    assert int((ratio < 0.999).sum()) >= 1 and int((ratio > 0.999).sum()) >= 1, ratio


def test_ant3d_step_matches_jax():
    _step_case("ant3d", js.step, ts.step, seed=8)


@pytest.mark.parametrize("name", list(PLANAR))
def test_autodiff_step_matches_the_row_engine(name):
    """The two engines of the port compute the same physics: the autodiff
    step against the row engine (kernel B1's plain version) at P = 4, h = 1,
    held at the tolerance the JAX package accepts between its two engines
    (2e-3 on q, 8e-2 on qd; tests/test_batched_physics.py)."""
    _, tm = _models(name)
    q, qd, a = map(torch.from_numpy, _inputs(tm, seed=9))
    got = torch.func.vmap(lambda *x: tp.step(tm, *x))(q, qd, a)
    qs, qds = rollout_planar_reference(tm, q, qd, a[:, None])
    np.testing.assert_allclose(got[0].numpy(), qs[0].numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[1].numpy(), qds[0].numpy(), rtol=0, atol=8e-2)


@pytest.mark.parametrize("name", list(SPATIAL))
def test_spatial_autodiff_step_matches_the_row_engine(name):
    """The spatial twin: the autodiff step against the row engine (kernel
    B2's plain version) at P = 4, h = 1, at the tolerance the JAX package
    accepts between its two spatial engines (2e-3 on q, 8e-2 on qd;
    tests/test_spatial_batched.py)."""
    _, tm = _models(name)
    q, qd, a = map(torch.from_numpy, _inputs(tm, seed=14))
    got = torch.func.vmap(lambda *x: ts.step(tm, *x))(q, qd, a)
    qs, qds = rollout_spatial_reference(tm, q, qd, a[:, None])
    np.testing.assert_allclose(got[0].numpy(), qs[0].numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[1].numpy(), qds[0].numpy(), rtol=0, atol=8e-2)


def test_constants_go_to_a_device_once():
    _, tm = _models("halfcheetah")
    q, qd, _ = map(torch.from_numpy, _inputs(tm, seed=10))
    tp.mass_matrix(tm, q[0])
    first = tp._constants(tm, "cpu")
    tp.bias_forces(tm, q[0], qd[0])
    assert tp._constants(tm, torch.device("cpu")) is first
    assert len(tm.__dict__["_engine_constants"]) == 1


def test_valve_env_step_runs_the_autodiff_engine():
    """A planar env whose model turns the valve on takes its real step
    through the autodiff engine and agrees with the JAX env's real step;
    its whole-horizon rollout stays on the valveless row engine."""
    kw = dict(exclude_current_positions_from_observation=True)
    jenv, env = JaxCheetah(**kw), HalfCheetah(**kw)
    jenv.model, env.model = (dataclasses.replace(m, energy_valve=True)
                             for m in (jenv.model, env.model))
    rng = np.random.default_rng(11)
    S = np.concatenate([rng.uniform(-0.1, 0.1, (P, 9)),
                        0.1 * rng.standard_normal((P, 9))], 1).astype(np.float32)
    A = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    js_, jobs, jrew, _ = jax.jit(jax.vmap(jenv.step))(jnp.asarray(S), jnp.asarray(A))
    s, obs, rew, _ = env.step_batched(torch.from_numpy(S), torch.from_numpy(A))
    np.testing.assert_allclose(s[:, :9].numpy(), np.asarray(js_[:, :9]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s[:, 9:].numpy(), np.asarray(js_[:, 9:]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4 / env.dt)
    want = torch.func.vmap(lambda *x: tp.step(env.model, *x))(
        torch.from_numpy(S[:, :9]), torch.from_numpy(S[:, 9:]), torch.from_numpy(A))
    assert torch.equal(s[:, :9], want[0]) and torch.equal(s[:, 9:], want[1])
    s1 = env.step(torch.from_numpy(S[0]), torch.from_numpy(A[0]))[0]
    # float32 roundoff: the batch size changes how a product sums
    np.testing.assert_allclose(s1.numpy(), s[0].numpy(), rtol=0, atol=1e-5)
    h = 3
    out = env.rollout_batched(torch.from_numpy(S), torch.from_numpy(
        rng.uniform(-1, 1, (P, h, 6)).astype(np.float32)))
    assert tuple(out[4].shape) == (P, 18)
