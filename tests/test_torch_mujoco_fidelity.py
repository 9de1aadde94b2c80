"""icem_torch's MJCF exporter and autodiff engines against a MuJoCo oracle.

The port's ``envs/physics/mjcf_export.py`` must give the JAX exporter's
document, character for character, for every model an env of the registry
carries (or refuse the same ones). The port's engines are then held to the
MuJoCo bounds of tests/test_mujoco_fidelity.py on the same models:
forward kinematics, mass matrix, bias and passive forces to float32
precision, and ballistic trajectories to the integrator's drift. The
oracle harness, ``python -m icem_torch.tools.fidelity_oracle``, runs at a
tiny horizon and writes the fields of scripts/fidelity_oracle.py.
"""

import dataclasses
import json
from importlib import import_module

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from icem_torch.envs import _ENV_REGISTRY, env_from_string  # noqa: E402
from icem_torch.envs.ant3d import make_ant3d_model  # noqa: E402
from icem_torch.envs.cheetah import HalfCheetah  # noqa: E402
from icem_torch.envs.hopper import Hopper  # noqa: E402
from icem_torch.envs.physics import mjcf_export, planar, spatial  # noqa: E402
from icem_torch.envs.planar_base import PlanarEnv  # noqa: E402
from icem_torch.envs.spatial_base import SpatialEnv  # noqa: E402
from icem_torch.tools import fidelity_oracle  # noqa: E402
from icem_tpu.envs import env_from_string as jax_env_from_string  # noqa: E402
from icem_tpu.envs.physics import mjcf_export as jax_mjcf_export  # noqa: E402

# the registry strings whose env carries a planar or spatial model
MODEL_ENVS = ("HalfCheetah", "Hopper", "Reacher", "Ant", "Humanoid", "HumanoidStandup",
              "PlanarAnt", "PlanarHumanoid", "PlanarHumanoidStandup", "cheetah", "reacher",
              "restricted_reacher", "swimmer")


def test_model_envs_are_every_env_with_a_model():
    with_model = {name for name, (module, cls) in _ENV_REGISTRY.items()
                  if issubclass(getattr(import_module(module), cls), (PlanarEnv, SpatialEnv))}
    assert with_model == set(MODEL_ENVS)


@pytest.mark.parametrize("name", MODEL_ENVS)
def test_mjcf_document_equals_the_jax_exporters(name):
    model, jmodel = env_from_string(name).model, jax_env_from_string(name).model
    spatial_model = hasattr(model, "axis")
    export = mjcf_export.spatial_to_mjcf if spatial_model else mjcf_export.planar_to_mjcf
    jexport = (jax_mjcf_export.spatial_to_mjcf if spatial_model
               else jax_mjcf_export.planar_to_mjcf)
    try:
        want = jexport(jmodel, name="m")
    except ValueError as e:   # an unexportable feature: both refuse it
        with pytest.raises(ValueError, match=str(e)):
            export(model, name="m")
        return
    assert export(model, name="m") == want
    mujoco.MjModel.from_xml_string(want)


def _mid_limits(model, rng, spread=0.15):
    q = 0.1 * rng.standard_normal(model.ndof)
    lo = np.asarray(model.limit_lo, np.float64)
    hi = np.asarray(model.limit_hi, np.float64)
    if lo.size:
        fin = np.isfinite(lo) & np.isfinite(hi)
        mid = np.where(fin, lo, 0.0) / 2.0 + np.where(fin, hi, 0.0) / 2.0
        span = np.where(fin, hi, 0.0) - np.where(fin, lo, 0.0)
        q[fin] = (mid + spread * span * np.tanh(q))[fin]
    return q


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def test_spatial_fk_matches_mujoco():
    model = make_ant3d_model()
    m = mujoco.MjModel.from_xml_string(mjcf_export.spatial_to_mjcf(model))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(0)
    for _ in range(3):
        q = 0.3 * rng.standard_normal(model.ndof)
        q[2] += 1.0
        d.qpos[:] = mjcf_export.qpos_from_q_spatial(q, model.free_root)
        mujoco.mj_forward(m, d)
        coms, _, gpts = (x.numpy() for x in spatial.fk(model, _t(q)))
        for g in range(len(model.geom_body)):
            gid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, f"g{g}")
            np.testing.assert_allclose(d.geom_xpos[gid], gpts[g], atol=1e-5)
        for b in range(model.nbody):
            bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, f"b{b}")
            np.testing.assert_allclose(d.xipos[bid], coms[b], atol=1e-5)


def test_spatial_mass_bias_passive_match_mujoco():
    model = make_ant3d_model()
    m = mujoco.MjModel.from_xml_string(mjcf_export.spatial_to_mjcf(model))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(1)
    perm = np.arange(model.ndof)
    perm[3], perm[5] = 5, 3
    q = _mid_limits(model, rng)
    q[2] += 1.0
    qd = 0.5 * rng.standard_normal(model.ndof)
    d.qpos[:] = mjcf_export.qpos_from_q_spatial(q, True)
    d.qvel[:] = mjcf_export.qvel_from_qd_spatial(qd, True)
    mujoco.mj_forward(m, d)

    M_ref = spatial.mass_matrix(model, _t(q)).numpy()
    Mmj = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, Mmj)
    np.testing.assert_allclose(Mmj[np.ix_(perm, perm)], M_ref, atol=3e-5 * np.abs(M_ref).max())
    b_ref = spatial.bias_forces(model, _t(q), _t(qd)).numpy()
    np.testing.assert_allclose(d.qfrc_bias[perm], b_ref,
                               atol=3e-5 * max(1.0, np.abs(b_ref).max()))
    damping = np.asarray(model.damping, np.float64)
    if damping.size == 0:
        damping = np.zeros(model.ndof)
    passive_ref = spatial.spring_forces(model, _t(q)).numpy() - damping * qd
    np.testing.assert_allclose(d.qfrc_passive[perm], passive_ref,
                               atol=3e-5 * max(1.0, np.abs(passive_ref).max()))


PLANAR_CASES = {"halfcheetah": lambda: HalfCheetah().model, "hopper": lambda: Hopper().model}


@pytest.mark.parametrize("name", sorted(PLANAR_CASES))
def test_planar_fk_mass_bias_match_mujoco(name):
    model = PLANAR_CASES[name]()
    m = mujoco.MjModel.from_xml_string(mjcf_export.planar_to_mjcf(model))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(2)
    q = 0.3 * rng.standard_normal(model.ndof)
    q[1] += 1.0
    qd = 0.5 * rng.standard_normal(model.ndof)
    d.qpos[:] = q
    d.qvel[:] = qd
    mujoco.mj_forward(m, d)
    gpts = planar.fk(model, _t(q))[2].numpy()
    for g in range(len(model.geom_body)):
        gid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, f"g{g}")
        np.testing.assert_allclose(d.geom_xpos[gid], [gpts[g, 0], 0.0, gpts[g, 1]], atol=1e-5)
    M_ref = planar.mass_matrix(model, _t(q)).numpy()
    Mmj = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, Mmj)
    np.testing.assert_allclose(Mmj, M_ref, atol=3e-5 * np.abs(M_ref).max())
    b_ref = planar.bias_forces(model, _t(q), _t(qd)).numpy()
    np.testing.assert_allclose(d.qfrc_bias, b_ref, atol=3e-5 * max(1.0, np.abs(b_ref).max()))


@pytest.mark.parametrize("name", sorted(PLANAR_CASES))
def test_planar_ballistic_trajectory_matches_mujoco(name):
    """Airborne, zero ctrl, inside limits: 5 control steps agree to the
    frozen-mass-matrix drift tests/test_mujoco_fidelity.py allows (1e-2)."""
    model = PLANAR_CASES[name]()
    m = mujoco.MjModel.from_xml_string(mjcf_export.planar_to_mjcf(model))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(3)
    q0 = _mid_limits(model, rng)
    q0[1] = 3.0
    qd0 = 0.2 * rng.standard_normal(model.ndof)
    d.qpos[:] = q0
    d.qvel[:] = qd0
    q, qd, a = _t(q0), _t(qd0), torch.zeros(len(model.actuator_dof))
    for _ in range(5):
        q, qd = planar.step(model, q, qd, a)
        d.ctrl[:] = 0.0
        for _ in range(model.n_substeps):
            mujoco.mj_step(m, d)
    np.testing.assert_allclose(q.numpy().astype(np.float64), d.qpos, atol=1e-2)


def test_spatial_ballistic_trajectory_matches_mujoco():
    model = make_ant3d_model()
    m = mujoco.MjModel.from_xml_string(mjcf_export.spatial_to_mjcf(model))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(4)
    q0 = _mid_limits(model, rng)
    q0[2] = 4.0
    qd0 = 0.2 * rng.standard_normal(model.ndof)
    d.qpos[:] = mjcf_export.qpos_from_q_spatial(q0, True)
    d.qvel[:] = mjcf_export.qvel_from_qd_spatial(qd0, True)
    q, qd, a = _t(q0), _t(qd0), torch.zeros(len(model.actuator_dof))
    for _ in range(5):
        q, qd = spatial.step(model, q, qd, a)
        d.ctrl[:] = 0.0
        for _ in range(model.n_substeps):
            mujoco.mj_step(m, d)
    qmj = mjcf_export.q_from_qpos_spatial(d.qpos.copy(), True)
    np.testing.assert_allclose(q.numpy().astype(np.float64), qmj, atol=5e-3)


def test_exporter_refuses_unexportable_features():
    with pytest.raises(ValueError, match="motor_omega_max"):
        mjcf_export.spatial_to_mjcf(dataclasses.replace(make_ant3d_model(), motor_omega_max=8.0))
    with pytest.raises(ValueError, match="drag"):
        mjcf_export.planar_to_mjcf(env_from_string("swimmer").model)


def test_state_converters_are_involutions_and_match_jax():
    q = np.arange(14, dtype=np.float64)
    qpos = mjcf_export.qpos_from_q_spatial(q, True)
    np.testing.assert_array_equal(qpos, jax_mjcf_export.qpos_from_q_spatial(q, True))
    assert list(qpos[3:6]) == [5.0, 4.0, 3.0]
    np.testing.assert_array_equal(mjcf_export.q_from_qpos_spatial(qpos, True), q)
    np.testing.assert_array_equal(mjcf_export.qvel_from_qd_spatial(q, False), q)


def test_fidelity_oracle_writes_its_fields(tmp_path):
    """The harness at a horizon of 2, one seed, the port's engine on the
    CPU: every env and regime with the scripts/fidelity_oracle.py fields; the
    airborne regimes within 1 cm of MuJoCo."""
    out = tmp_path / "fidelity.json"
    fidelity_oracle.main(["--out", str(out), "--horizon", "2", "--seeds", "1",
                          "--device", "cpu"])
    res = json.loads(out.read_text())
    assert set(res["envs"]) == {"ant3d", "halfcheetah", "hopper", "humanoid3d"}
    for name, regimes in res["envs"].items():
        assert set(regimes) == {"ballistic", "smooth", "contact"}
        for regime, r in regimes.items():
            assert len(r["q_rmse_mean"]) == len(r["com_drift_mean"]) == 2, (name, regime)
            assert r["divergence_step_5cm_mean"] <= 2 and r["nan_steps"] == [None]
            if regime != "contact":
                assert max(r["com_drift_mean"]) < 0.01, (name, regime, r["com_drift_mean"])
