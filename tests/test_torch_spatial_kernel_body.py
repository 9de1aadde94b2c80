"""The spatial rollout kernel's body, built for the CPU.

``csrc/spatial_step.cuh`` holds the per-trajectory physics once, for nvcc and
for a host compiler, as phases of a warp over a workspace. Here g++ builds it
through the test-only shim ``csrc/spatial_rollout_host.cpp``, which runs each
phase for lanes 0..31 in turn, at the two shapes the device launches, Ant3D
<14, 9, 9, 8> and Humanoid3D <23, 18, 13, 17>, and at a hinge-root chain
<3, 3, 1, 3>, and it is held against the plain version,
``rollout_spatial_reference``, with the kernel's own parameter packing and
layouts.

The rule is B1's, per trajectory (tests/test_torch_kernel_body.py): over
the first 3 control steps |dq| < 1e-4, or, for a trajectory that crosses a
contact or limit switch within roundoff, its one-step errors replayed from
the body's own states < 1e-4. Over a longer horizon the dynamics amplify
roundoff: the 0.999 quantile of the one-step errors from the body's own
states stays < 1e-4, and the 0.99 quantile of |dq| over the last 10 steps
< 1e-3.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from icem_torch.envs.ant3d import Ant3D
from icem_torch.envs.humanoid3d import HumanoidStandup3D
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.ops import spatial_rollout as sr
from icem_torch.ops._build import CSRC
from icem_torch.runtime import metrics


def _hinge_tree():
    """A three-link hinge-root chain with skew axes (no free root, a joint
    without limits, a dof without spring)."""
    ax1 = np.array([0.6, 0.0, 0.8])
    ax2 = np.array([0.0, 1.0, 0.0])
    return SpatialModel(
        parent=(-1, 0, 1),
        anchor=np.array([[0.0, 0.0, 0.3], [0.4, 0.0, 0.0], [0.4, 0.1, 0.0]], np.float32),
        axis=np.stack([ax1, ax2, ax1]).astype(np.float32),
        com=np.array([[0.2, 0.0, 0.0]] * 3, np.float32),
        mass=np.array([1.0, 0.7, 0.4], np.float32),
        inertia=np.array([[0.02, 0.03, 0.02]] * 3, np.float32),
        free_root=False, geom_body=(2,),
        geom_pos=np.array([[0.4, 0.0, 0.0]], np.float32),
        geom_radius=np.array([0.05], np.float32),
        actuator_dof=(0, 1, 2), gear=np.array([10.0, 8.0, 5.0], np.float32),
        damping=np.array([0.5, 0.3, 0.2], np.float32),
        stiffness=np.array([2.0, 1.0, 0.0], np.float32),
        springref=np.array([0.1, 0.0, 0.0], np.float32),
        limit_lo=np.array([-1.2, -np.inf, -2.0], np.float32),
        limit_hi=np.array([1.2, np.inf, 2.0], np.float32),
        energy_valve=True, dt=0.02, n_substeps=4)


ENVS = {"ant3d": Ant3D, "humanoid3d": HumanoidStandup3D}


def _model(name):
    return _hinge_tree() if name == "hinge_tree" else ENVS[name]().model


def _inputs(name, P, h, seed):
    """States near the env's start distribution (random for the chain) and
    uniform actions, made with numpy."""
    model = _model(name)
    rng = np.random.default_rng(seed)
    n, na = model.ndof, len(model.actuator_dof)
    if name == "hinge_tree":
        Q = 0.5 * rng.standard_normal((P, n))
        QD = 0.5 * rng.standard_normal((P, n))
    else:
        env = ENVS[name]()
        gen = torch.Generator().manual_seed(seed)
        S = torch.stack([env.init_state(gen) for _ in range(8)]).numpy()[np.arange(P) % 8]
        Q = S[:, :n] + 0.05 * rng.standard_normal((P, n))
        QD = S[:, n:] + 0.1 * rng.standard_normal((P, n))
    A = rng.uniform(-1, 1, (P, h, na))
    return model, Q.astype(np.float32), QD.astype(np.float32), A.astype(np.float32)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("spatial_host") / "libspatial_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(out),
                    str(CSRC / "spatial_rollout_host.cpp")], check=True)
    return ctypes.CDLL(str(out))


def _rows(x):
    """x [P, nd] as the kernel takes it: its rows where they are, at their
    stride in floats, once its columns are adjacent."""
    if x.strides[1] != x.itemsize:
        x = np.ascontiguousarray(x)
    return x, x.strides[0] // x.itemsize


def _host_rollout(lib, model, Q, QD, A, descending=False):
    """The body run lane by lane, in the kernel's layouts: Q, QD [P, nd]
    with a row stride and A [P, h, na] as they are, (qs, qds) [h, P, nd]."""
    shape = "_".join(map(str, sr.kernel_shape(model)))
    fn = getattr(lib, f"spatial_rollout_host_{shape}")
    fn.restype = ctypes.c_int
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ll, ptr, ll, ptr, ptr, ptr, ll, ctypes.c_int, ctypes.c_int]
    P, h = A.shape[0], A.shape[1]
    params = sr.pack_params(model)
    (q0, ldq), (qd0, ldqd) = _rows(Q), _rows(QD)
    acts = np.ascontiguousarray(A)
    qs = np.empty((h, P, model.ndof), np.float32)
    qds = np.empty_like(qs)
    assert fn(params.ctypes.data, q0.ctypes.data, ldq, qd0.ctypes.data, ldqd,
              acts.ctypes.data, qs.ctypes.data, qds.ctypes.data, P, h, int(descending)) == 0
    return qs, qds


def _one_step_errors(model, Q, QD, A, qs, qds):
    """max |dq| of every step of every trajectory, with the plain version
    started from the body's own state at the start of that step: [h, P]."""
    h, P, n = qs.shape
    starts_q = np.concatenate([Q[None], qs[:-1]]).reshape(-1, n)
    starts_qd = np.concatenate([QD[None], qds[:-1]]).reshape(-1, n)
    acts = np.ascontiguousarray(A.transpose(1, 0, 2)).reshape(-1, 1, A.shape[2])
    rq, _ = sr.rollout_spatial_reference(model, *map(torch.from_numpy,
                                                     (starts_q, starts_qd, acts)))
    return np.abs(rq[0].numpy().reshape(h, P, n) - qs).max(axis=2)


@pytest.mark.parametrize("name", ["ant3d", "humanoid3d", "hinge_tree"])
def test_kernel_body_matches_plain_version(host_lib, name):
    model, Q, QD, A = _inputs(name, P=32, h=3, seed=0)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A)
    rq, rqd = sr.rollout_spatial_reference(model, *map(torch.from_numpy, (Q, QD, A)))
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    per_traj = np.abs(qs - rq.numpy()).max(axis=(0, 2))
    diverged = per_traj >= 1e-4
    if diverged.any():
        local = _one_step_errors(model, Q, QD, A, qs, qds)[:, diverged]
        assert local.max() < 1e-4, (np.nonzero(diverged), local.max())
    # the JAX repo's own spatial bulk rule (tests/test_pallas_rollout.py:99-101)
    gap = np.abs(qs - rq.numpy())
    assert np.quantile(gap, 0.999) < 1e-3 and gap.max() < 5e-2


@pytest.mark.parametrize("name,h", [("ant3d", 30), ("humanoid3d", 10)])
def test_kernel_body_over_a_long_horizon(host_lib, name, h):
    """Ant3D over the planner's h = 30; HumanoidStandup3D over 10 steps (its
    plain version costs most). The gap to the plain version grows with the
    horizon because stiff contacts and limit switches amplify roundoff; every
    step's own error, replayed from the body's states, stays at roundoff."""
    model, Q, QD, A = _inputs(name, P=48, h=h, seed=3)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A)
    rq, _ = sr.rollout_spatial_reference(model, *map(torch.from_numpy, (Q, QD, A)))
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    local = _one_step_errors(model, Q, QD, A, qs, qds)
    # a step that meets a switch within roundoff diverges even from a shared
    # start state, so the bulk is held, not the largest
    assert np.quantile(local, 0.999) < 1e-4, np.quantile(local, 0.999)
    gap = np.abs(qs - rq.numpy())
    assert np.quantile(gap[-10:], 0.99) < 1e-3


@pytest.mark.parametrize("name", ["ant3d", "humanoid3d", "hinge_tree"])
def test_lane_order_does_not_change_the_result(host_lib, name):
    """On the card the 32 lanes of a phase run at once. A phase that read a
    slot another lane writes in the same phase would race there; here it
    makes the two lane orders disagree, so they must agree to the bit."""
    model, Q, QD, A = _inputs(name, P=8, h=3, seed=5)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A)
    qs_r, qds_r = _host_rollout(host_lib, model, Q, QD, A, descending=True)
    # the shim fills each workspace with NaNs: a slot read unwritten shows
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    np.testing.assert_array_equal(qs, qs_r)
    np.testing.assert_array_equal(qds, qds_r)


@pytest.mark.parametrize("name", ["ant3d", "humanoid3d", "hinge_tree"])
def test_kernel_body_reads_strided_rows(host_lib, name):
    """The env passes Q and QD as column slices of its [P, 2 nd + k] state;
    the body reads them at that row stride and gives what it gives on
    contiguous copies, to the bit."""
    model, Q, QD, A = _inputs(name, P=8, h=3, seed=7)
    n = model.ndof
    states = np.concatenate([Q, QD, np.full((len(Q), 3), np.nan, np.float32)], axis=1)
    q_view, qd_view = states[:, :n], states[:, n:2 * n]
    assert _rows(q_view)[1] == _rows(qd_view)[1] == 2 * n + 3
    qs, qds = _host_rollout(host_lib, model, q_view, qd_view, A)
    qs_c, qds_c = _host_rollout(host_lib, model, Q, QD, A)
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    np.testing.assert_array_equal(qs, qs_c)
    np.testing.assert_array_equal(qds, qds_c)


@pytest.mark.parametrize("name,max_depth", [("ant3d", 2), ("humanoid3d", 7),
                                            ("hinge_tree", 2)])
def test_pack_params_depths(name, max_depth):
    """The kernel runs forward kinematics and the velocity pass one tree
    level per phase, by the packed depths."""
    model = _model(name)
    rec = sr.pack_params(model)
    for b, pa in enumerate(model.parent):
        assert rec["depth"][b] == (0 if pa < 0 else rec["depth"][pa] + 1)
    assert rec["max_depth"] == max(rec["depth"]) == max_depth


@pytest.mark.parametrize("name", ["ant3d", "humanoid3d", "hinge_tree"])
def test_parameter_block_matches_the_struct(host_lib, name):
    model = _model(name)
    shape = "_".join(map(str, sr.kernel_shape(model)))
    sizeof = getattr(host_lib, f"spatial_params_bytes_{shape}")
    sizeof.restype = ctypes.c_int
    assert sr.pack_params(model).nbytes == sizeof()


def test_pack_params_tables():
    model = Ant3D().model
    rec = sr.pack_params(model)
    # bit r of chain_mask[b]: rotational dof r (dof r + 3) on the chain root..b
    assert list(rec["chain_mask"]) == [0b111, 0b1111, 0b11111, 0b100111, 0b1100111,
                                       0b10000111, 0b110000111, 0b1000000111,
                                       0b11000000111]
    assert list(rec["geom_chain_mask"]) == [rec["chain_mask"][b] for b in model.geom_body]
    assert rec["actuated_mask"] == 0b11111111000000
    assert rec["spring_mask"] == rec["hi_mask"] == rec["lo_mask"] == 0b11111111000000
    assert (rec["finite_motor"], rec["finite_fmax"], rec["valve"], rec["n_substeps"]) == \
        (0, 1, 1, 20)
    # constants folded in float64, rounded once
    mass = np.asarray(model.mass, np.float64)
    assert rec["trans_diag"] == np.float32(mass.sum() + 1e-6)
    assert rec["pen_star"] == np.float32(1500.0 / 2.0e4)
    assert rec["dt_sub"] == np.float32(0.05 / 20)
    np.testing.assert_array_equal(rec["grav_mass"], (9.81 * mass).astype(np.float32))
    np.testing.assert_array_equal(rec["max_qd"], np.full(14, 50.0, np.float32))
    # a z-axis hinge: K has 2 nonzero entries, K @ K 2 on the diagonal
    assert (rec["rod_k_mask"][1], rec["rod_k2_mask"][1]) == (0b000001010, 0b000010001)

    humanoid = HumanoidStandup3D().model
    hrec = sr.pack_params(humanoid)
    np.testing.assert_array_equal(hrec["max_qd"], humanoid.max_qd)
    np.testing.assert_array_equal(hrec["root_rot_offset"], humanoid.root_rot_offset)
    assert hrec["finite_motor"] == 1 and hrec["motor_omega_max"] == 8.0
    chain = _hinge_tree()
    crec = sr.pack_params(chain)
    assert list(crec["chain_mask"]) == [0b1, 0b11, 0b111]
    assert (crec["hi_mask"], crec["lo_mask"], crec["spring_mask"]) == (0b101, 0b101, 0b011)
    assert crec["finite_fmax"] == 0 and not np.isfinite(crec["pen_star"])


def test_rollout_spatial_checks_its_inputs():
    model = Ant3D().model
    Q = torch.zeros(4, 14)
    A = torch.zeros(4, 3, 8)
    with pytest.raises(ValueError, match="Q, QD"):
        sr.rollout_spatial(model, torch.zeros(4, 13), torch.zeros(4, 13), A)
    with pytest.raises(ValueError, match="ACTS"):
        sr.rollout_spatial(model, Q, Q, torch.zeros(4, 3, 5))
    with pytest.raises(TypeError, match="float32"):
        sr.rollout_spatial(model, Q.double(), Q.double(), A)
    Q[:, 2] = 1.0
    before = metrics.counters()
    qs, qds = sr.rollout_spatial(model, Q, Q, A)
    assert tuple(qs.shape) == tuple(qds.shape) == (3, 4, 14)
    # the CPU runs the plain version and counts no kernel launch
    assert metrics.since(before).get("b2.launches", 0) == 0
