"""icem_torch's planar row engine against the JAX package's batched engine.

The JAX models are carried over with ``convert.planar_model_from_arrays``, so
both packages compute from identical constants; identical states and controls
are made with numpy from a seed. Covered: HalfCheetah (free root, contacts,
joint limits), a two-link arm (hinge root) and a six-link swimmer (fluid drag).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_tpu.envs.cheetah import make_cheetah_model as jax_cheetah_model
from icem_tpu.envs.dm_suite import make_swimmer_model
from icem_tpu.envs.physics import batched as jb
from icem_tpu.envs.reacher import make_arm_model
from icem_torch.convert import planar_model_from_arrays
from icem_torch.envs.cheetah import make_cheetah_model
from icem_torch.envs.physics import batched as tb
from icem_torch.ops.planar_rollout import rollout_planar_reference

MODELS = {
    "cheetah": lambda: jax_cheetah_model(dt=0.05, n_substeps=20),
    # Reacher's arm: l1, l2, dt, substeps, torque, damping (envs/reacher.py)
    "arm": lambda: make_arm_model(0.1, 0.11, 0.02, 4, 0.05, 0.01),
    "swimmer": lambda: make_swimmer_model(),
}


def _port(jax_model):
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in dataclasses.asdict(jax_model).items()}
    return planar_model_from_arrays(fields)


def _inputs(model, P, seed):
    rng = np.random.default_rng(seed)
    n, na = model.ndof, len(model.actuator_dof)
    Q = (rng.standard_normal((P, n)) * 0.05).astype(np.float32)
    QD = (rng.standard_normal((P, n)) * 0.1).astype(np.float32)
    C = rng.uniform(-1, 1, size=(P, na)).astype(np.float32)
    return Q, QD, C


@pytest.mark.parametrize("name", list(MODELS))
def test_step_rows_matches_jax_step_batched(name):
    jm = MODELS[name]()
    tm = _port(jm)
    P = 64
    Q, QD, C = _inputs(tm, P, seed=1)
    jstep = jax.jit(lambda a, b, c: jb.step_batched(jm, a, b, c))
    jq, jqd = jnp.asarray(Q), jnp.asarray(QD)
    tq, tqd = torch.from_numpy(Q), torch.from_numpy(QD)
    for step, atol in enumerate((1e-4, 1e-3, 1e-3)):
        jq, jqd = jstep(jq, jqd, jnp.asarray(C))
        tqs, tqds = rollout_planar_reference(tm, tq, tqd, torch.from_numpy(C)[:, None])
        tq, tqd = tqs[0], tqds[0]
        assert tq.dtype == torch.float32
        # the same float32 operations in another order, amplified by stiff
        # contacts over the substeps: tight after one step, 1e-3 after three
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=atol,
                                   err_msg=f"q after step {step + 1}")
    assert np.all(np.isfinite(tqd.numpy()))


def _rows_to_array(rows, P):
    return np.stack([np.broadcast_to(np.asarray(r, np.float32), (P,)) for r in rows], axis=-1)


@pytest.mark.parametrize("name", list(MODELS))
def test_mass_bias_matches_jax(name):
    jm = MODELS[name]()
    tm = _port(jm)
    P = 64
    rng = np.random.default_rng(2)
    Q = (rng.standard_normal((P, tm.ndof)) * 0.3).astype(np.float32)
    QD = (rng.standard_normal((P, tm.ndof)) * 0.5).astype(np.float32)
    jM, jbias = jax.jit(lambda q, qd: jb.mass_bias_batched(jm, list(q.T), list(qd.T)))(
        jnp.asarray(Q), jnp.asarray(QD))
    tM, tbias = tb.mass_bias_batched(tm, list(torch.from_numpy(Q).T),
                                     list(torch.from_numpy(QD).T))
    n = tm.ndof
    for i in range(n):
        np.testing.assert_allclose(
            _rows_to_array([tM[i][j] for j in range(n)], P),
            _rows_to_array([jM[i][j] for j in range(n)], P), rtol=1e-5, atol=1e-6,
            err_msg=f"M row {i}")
    np.testing.assert_allclose(_rows_to_array(tbias, P), _rows_to_array(jbias, P),
                               rtol=1e-5, atol=1e-5)


def test_cholesky_rows_pivot_floor():
    """A near-singular pivot is floored at 1e-5 * A_ii (and 1e-9), not
    taken as is: the same factor as the JAX engine's."""
    n = 2
    A = [[torch.tensor([4.0, 1.0]), None], [torch.tensor([2.0, 1.0]), torch.tensor([1.0, 1.0])]]
    L = tb._cholesky_rows(A, n)
    jL = jb._cholesky_rows([[jnp.asarray(x.numpy()) if x is not None else None for x in row]
                            for row in A], n)
    for i in range(n):
        for j in range(i + 1):
            np.testing.assert_allclose(L[i][j].numpy(), np.asarray(jL[i][j]), rtol=1e-6)
    # the second row is singular: its pivot sits at the floor
    np.testing.assert_allclose(float(L[1][1][1]), np.sqrt(1e-5), rtol=1e-5)
    b = [torch.tensor([1.0, 1.0]), torch.tensor([2.0, 2.0])]
    x = tb._chol_solve_rows(L, b, n)
    jx = jb._chol_solve_rows(jL, [jnp.asarray(v.numpy()) for v in b], n)
    for a, c in zip(x, jx):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)


def test_ancestor_tables_match_jax():
    for make in MODELS.values():
        jm = make()
        tm = _port(jm)
        chains = tb._ancestors(tm)
        assert chains == jb._ancestors(jm)
        assert tb._hinge_ancestors(tm, chains) == jb._hinge_ancestors(jm, chains)


def test_convert_carries_every_field():
    jm = jax_cheetah_model(dt=0.05, n_substeps=20)
    tm = _port(jm)
    ours = make_cheetah_model(dt=0.05, n_substeps=20)
    for f in dataclasses.fields(tm):
        a, b, c = getattr(tm, f.name), getattr(ours, f.name), getattr(jm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            np.testing.assert_array_equal(a, c, err_msg=f.name)
        else:
            assert a == b == c, f.name
    assert (tm.nbody, tm.ndof, tm.dof_of_body(3)) == (7, 9, 5)
    with pytest.raises(ValueError, match="unknown PlanarModel fields"):
        planar_model_from_arrays({**dataclasses.asdict(jm), "bogus": 1})
