"""The rollout kernel's body, built for the CPU.

``csrc/planar_step.cuh`` holds the per-trajectory physics once, for nvcc and
for a host compiler. Here g++ builds it through the test-only shim
``csrc/planar_rollout_host.cpp`` and it is held against the plain version,
``rollout_planar_reference``, with the kernel's own parameter packing and
trajectory-minor layouts. Tolerance 1e-4: the same float32 operations in
another order.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from icem_torch.envs.cheetah import make_cheetah_model
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.ops import planar_rollout as pr
from icem_torch.ops._build import CSRC


def _arm():
    inf = np.inf
    return PlanarModel(
        parent=(-1, 0), anchor=np.array([[0.0, 0.0], [0.1, 0.0]], np.float32),
        com=np.array([[0.05, 0.0], [0.055, 0.0]], np.float32),
        mass=np.array([0.1, 0.1], np.float32),
        inertia=np.array([8.3e-5, 1.0e-4], np.float32), free_root=False,
        actuator_dof=(0, 1), gear=np.array([0.05, 0.05], np.float32),
        damping=np.array([0.01, 0.01], np.float32),
        limit_lo=np.array([-inf, -3.0], np.float32),
        limit_hi=np.array([inf, 3.0], np.float32), gravity=0.0, dt=0.02, n_substeps=4)


def _swimmer():
    n = 6
    return PlanarModel(
        parent=tuple([-1] + list(range(n - 1))),
        anchor=np.array([[0.0, 0.0]] + [[-0.1, 0.0]] * (n - 1), np.float32),
        com=np.tile(np.array([-0.05, 0.0], np.float32), (n, 1)),
        mass=np.full(n, 0.1, np.float32), inertia=np.full(n, 8.3e-5, np.float32),
        actuator_dof=tuple(range(3, n + 2)), gear=np.full(n - 1, 0.25, np.float32),
        damping=np.array([0, 0, 0] + [0.02] * (n - 1), np.float32),
        drag_normal=np.full(n, 12.0, np.float32), drag_tangent=np.full(n, 0.4, np.float32),
        drag_angular=np.full(n, 0.05, np.float32), gravity=0.0, dt=0.03, n_substeps=6)


MODELS = {
    "cheetah": lambda: make_cheetah_model(dt=0.05, n_substeps=20),
    "arm": _arm,          # hinge root
    "swimmer": _swimmer,  # fluid drag
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("planar_host") / "libplanar_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(out),
                    str(CSRC / "planar_rollout_host.cpp")], check=True)
    return ctypes.CDLL(str(out))


def _host_rollout(lib, model, Q, QD, A):
    shape = "_".join(map(str, pr.kernel_shape(model)))
    fn = getattr(lib, f"planar_rollout_host_{shape}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int]
    P, h = A.shape[0], A.shape[1]
    params = pr.pack_params(model)
    q0, qd0 = np.ascontiguousarray(Q.T), np.ascontiguousarray(QD.T)
    acts = np.ascontiguousarray(A.transpose(1, 2, 0))
    qs = np.empty((h, model.ndof, P), np.float32)
    qds = np.empty_like(qs)
    assert fn(params.ctypes.data, q0.ctypes.data, qd0.ctypes.data, acts.ctypes.data,
              qs.ctypes.data, qds.ctypes.data, P, h) == 0
    return qs.transpose(0, 2, 1), qds.transpose(0, 2, 1)


@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_body_matches_plain_version(host_lib, name):
    model = MODELS[name]()
    P, h = 64, 5
    rng = np.random.default_rng(0)
    nd, na = model.ndof, len(model.actuator_dof)
    Q = rng.uniform(-0.1, 0.1, (P, nd)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, nd))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, na)).astype(np.float32)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A)
    rq, rqd = pr.rollout_planar_reference(model, *map(torch.from_numpy, (Q, QD, A)))
    np.testing.assert_allclose(qs, rq.numpy(), atol=1e-4)
    np.testing.assert_allclose(qds, rqd.numpy(), atol=1e-3)


def test_kernel_body_over_the_whole_horizon(host_lib):
    """HalfCheetah over h = 30. The gap to the plain version grows late in
    the horizon, because the dynamics amplify roundoff: stiff penalty
    contacts, and a limit-damping switch that flips when q sits within
    roundoff of a joint limit. A one-ulp change of the start state, run
    through the body itself, opens a gap of the same size, so the late gap
    is held to that: its 0.99 quantile over steps 21-30 within 4x of the
    one-ulp gap's, and under 1e-3."""
    model = make_cheetah_model(dt=0.05, n_substeps=20)
    P, h = 256, 30
    rng = np.random.default_rng(3)
    Q = rng.uniform(-0.1, 0.1, (P, 9)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, 9))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, 6)).astype(np.float32)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A)
    qs_ulp, _ = _host_rollout(host_lib, model, np.nextafter(Q, np.float32(np.inf)), QD, A)
    rq, _ = pr.rollout_planar_reference(model, *map(torch.from_numpy, (Q, QD, A)))
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    gap = np.abs(qs - rq.numpy())
    ulp_gap = np.abs(qs - qs_ulp)
    np.testing.assert_array_less(gap[:3].max(), 1e-4)
    late, late_ulp = np.quantile(gap[20:], 0.99), np.quantile(ulp_gap[20:], 0.99)
    assert late < 1e-3, late
    assert late < 4 * late_ulp, (late, late_ulp)


@pytest.mark.parametrize("name", list(MODELS))
def test_parameter_block_matches_the_struct(host_lib, name):
    model = MODELS[name]()
    shape = "_".join(map(str, pr.kernel_shape(model)))
    sizeof = getattr(host_lib, f"planar_params_bytes_{shape}")
    sizeof.restype = ctypes.c_int
    assert pr.pack_params(model).nbytes == sizeof()


def test_pack_params_tree_tables():
    rec = pr.pack_params(make_cheetah_model())
    # bit c of anc_mask[b]: body c lies on the chain from the root to b
    assert list(rec["anc_mask"]) == [0b1, 0b11, 0b111, 0b1111, 0b10001, 0b110001, 0b1110001]
    assert list(rec["geom_anc_mask"]) == [rec["anc_mask"][b] for b in (3, 6, 2, 5, 0, 0)]
    assert rec["actuated_mask"] == 0b111111000
    assert (rec["has_drag"], rec["finite_motor"], rec["n_substeps"]) == (0, 0, 10)
    assert np.isinf(rec["limit_hi"][0]) and rec["limit_hi"][3] == np.float32(1.05)
    assert rec["dt_sub"] == np.float32(0.005)


def test_rollout_planar_checks_its_inputs():
    model = make_cheetah_model()
    Q = torch.zeros(4, 9)
    A = torch.zeros(4, 3, 6)
    with pytest.raises(ValueError, match="Q, QD"):
        pr.rollout_planar(model, torch.zeros(4, 8), torch.zeros(4, 8), A)
    with pytest.raises(ValueError, match="ACTS"):
        pr.rollout_planar(model, Q, Q, torch.zeros(4, 3, 5))
    with pytest.raises(TypeError, match="float32"):
        pr.rollout_planar(model, Q.double(), Q.double(), A)
    before = pr.LAUNCHES
    qs, qds = pr.rollout_planar(model, Q, Q, A)
    assert tuple(qs.shape) == tuple(qds.shape) == (3, 4, 9)
    # the CPU runs the plain version and counts no kernel launch
    assert pr.LAUNCHES == before
