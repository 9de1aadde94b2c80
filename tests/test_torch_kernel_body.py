"""The rollout kernel's body, built for the CPU.

``csrc/planar_step.cuh`` holds the per-trajectory physics once, for nvcc and
for a host compiler, as phases of a group of lanes over a workspace. Here g++
builds it through the test-only shim ``csrc/planar_rollout_host.cpp``, which
runs each phase for the group's lanes in turn, at the lanes of each of the
kernel's two instantiations, and it is held against the
plain version, ``rollout_planar_reference``, with the kernel's own parameter
packing and layouts. Tolerance 1e-4: the same float32 operations in another
order.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from icem_torch.envs.ant import make_ant_model
from icem_torch.envs.cheetah import make_cheetah_model
from icem_torch.envs.hopper import make_hopper_model
from icem_torch.envs.humanoid import make_humanoid_model
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.ops import planar_rollout as pr
from icem_torch.ops._build import CSRC
from icem_torch.runtime import metrics


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
    "hopper": make_hopper_model,
    "planar_ant": make_ant_model,
    "planar_humanoid": make_humanoid_model,  # the motor speed line
}


# Models whose dynamics turn a one-ulp change of the start positions into a
# gap past 1e-3 on qd within the 5 steps compared (the Hopper: gear 200 on
# light links, qd up to its 50 rad/s rail). The body and the plain version
# differ in their sines' last bits, so there the gap is held within 4x of
# that one-ulp gap.
AMPLIFIES_ROUNDOFF = ("hopper",)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("planar_host") / "libplanar_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(out),
                    str(CSRC / "planar_rollout_host.cpp")], check=True)
    return ctypes.CDLL(str(out))


def _rows(x):
    """x [P, nd] as the kernel takes it: its rows where they are, at their
    stride in floats, once its columns are adjacent."""
    if x.strides[1] != x.itemsize:
        x = np.ascontiguousarray(x)
    return x, x.strides[0] // x.itemsize


def _host_rollout(lib, model, Q, QD, A, descending=False, latency=pr.THROUGHPUT):
    """The body run lane by lane at the G of one of the kernel's
    instantiations, in the kernel's layouts: Q, QD [P, nd] with a row stride
    and A [P, h, na] as they are, (qs, qds) [h, P, nd]."""
    shape = "_".join(map(str, pr.kernel_shape(model)))
    fn = getattr(lib, f"planar_rollout_host_{shape}_{latency}")
    fn.restype = ctypes.c_int
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ll, ptr, ll, ptr, ptr, ptr, ll, ctypes.c_int, ctypes.c_int]
    P, h = A.shape[0], A.shape[1]
    params = pr.pack_params(model)
    (q0, ldq), (qd0, ldqd) = _rows(Q), _rows(QD)
    acts = np.ascontiguousarray(A)
    qs = np.empty((h, P, model.ndof), np.float32)
    qds = np.empty_like(qs)
    assert fn(params.ctypes.data, q0.ctypes.data, ldq, qd0.ctypes.data, ldqd,
              acts.ctypes.data, qs.ctypes.data, qds.ctypes.data, P, h, int(descending)) == 0
    return qs, qds


def _inputs(model, P, h, seed):
    rng = np.random.default_rng(seed)
    nd, na = model.ndof, len(model.actuator_dof)
    Q = rng.uniform(-0.1, 0.1, (P, nd)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, nd))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, na)).astype(np.float32)
    return Q, QD, A


# every shape at both of the kernel's widths: the throughput one (G = 2)
# under the shape's name, the latency one (a lane per item) beside it
WIDTHS = ([pytest.param(name, pr.THROUGHPUT, id=name) for name in MODELS]
          + [pytest.param(name, pr.LATENCY, id=f"{name}-latency") for name in MODELS])


@pytest.mark.parametrize("name, latency", WIDTHS)
def test_kernel_body_matches_plain_version(host_lib, name, latency):
    model = MODELS[name]()
    P, h = 64, 5
    rng = np.random.default_rng(0)
    nd, na = model.ndof, len(model.actuator_dof)
    Q = rng.uniform(-0.1, 0.1, (P, nd)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, nd))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, na)).astype(np.float32)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A, latency=latency)
    rq, rqd = pr.rollout_planar_reference(model, *map(torch.from_numpy, (Q, QD, A)))
    if name in AMPLIFIES_ROUNDOFF:
        # the gap a one-ulp change of the start positions opens in the body
        # itself, as in test_kernel_body_over_the_whole_horizon
        qs_u, qds_u = _host_rollout(host_lib, model, np.nextafter(Q, np.float32(np.inf)), QD, A,
                                    latency=latency)
        for got, want, ulp, atol in ((qs, rq, qs_u, 1e-4), (qds, rqd, qds_u, 1e-3)):
            gap = np.abs(got - want.numpy()).max()
            assert gap < max(atol, 4 * np.abs(got - ulp).max()), gap
        return
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


@pytest.mark.parametrize("name, latency", WIDTHS)
def test_lane_order_does_not_change_the_result(host_lib, name, latency):
    """On the card the lanes of a group run a phase at once. A phase that
    read a slot another lane writes in the same phase would race there; here
    it makes the two lane orders disagree, so they must agree to the bit."""
    model = MODELS[name]()
    Q, QD, A = _inputs(model, P=8, h=4, seed=5)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A, latency=latency)
    qs_r, qds_r = _host_rollout(host_lib, model, Q, QD, A, descending=True, latency=latency)
    # the shim fills each workspace with NaNs: a slot read unwritten shows
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    np.testing.assert_array_equal(qs, qs_r)
    np.testing.assert_array_equal(qds, qds_r)


@pytest.mark.parametrize("name, latency", WIDTHS)
def test_kernel_body_reads_strided_rows(host_lib, name, latency):
    """The env passes Q and QD as column slices of its [P, 2 nd + k] state;
    the body reads them at that row stride and gives what it gives on
    contiguous copies, to the bit."""
    model = MODELS[name]()
    Q, QD, A = _inputs(model, P=8, h=3, seed=7)
    n = model.ndof
    states = np.concatenate([Q, QD, np.full((len(Q), 3), np.nan, np.float32)], axis=1)
    q_view, qd_view = states[:, :n], states[:, n:2 * n]
    assert _rows(q_view)[1] == _rows(qd_view)[1] == 2 * n + 3
    qs, qds = _host_rollout(host_lib, model, q_view, qd_view, A, latency=latency)
    qs_c, qds_c = _host_rollout(host_lib, model, Q, QD, A, latency=latency)
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    np.testing.assert_array_equal(qs, qs_c)
    np.testing.assert_array_equal(qds, qds_c)


@pytest.mark.parametrize("name", list(MODELS))
def test_both_widths_give_the_same_bits(host_lib, name):
    """Each phase computes an item with the same expression whichever lane
    takes it, so the two instantiations' G give the same bits."""
    model = MODELS[name]()
    Q, QD, A = _inputs(model, P=16, h=5, seed=11)
    qs, qds = _host_rollout(host_lib, model, Q, QD, A, latency=pr.THROUGHPUT)
    qs_l, qds_l = _host_rollout(host_lib, model, Q, QD, A, latency=pr.LATENCY)
    assert np.all(np.isfinite(qs)) and np.all(np.isfinite(qds))
    np.testing.assert_array_equal(qs_l, qs)
    np.testing.assert_array_equal(qds_l, qds)


@pytest.mark.parametrize("name", list(MODELS))
def test_lanes_per_trajectory_of_each_width(host_lib, name):
    """The body's G at each width is the one the host's rule assumes: 2, and
    the smallest power of two that holds the shape's largest item count."""
    shape = pr.kernel_shape(MODELS[name]())
    tag = "_".join(map(str, shape))
    lanes = [getattr(host_lib, f"planar_lanes_{tag}_{w}") for w in (pr.THROUGHPUT, pr.LATENCY)]
    for fn in lanes:
        fn.restype = ctypes.c_int
    assert [fn() for fn in lanes] == [pr.THROUGHPUT_LANES, pr.latency_lanes(shape)]
    assert pr.latency_lanes(shape) == {"cheetah": 16, "planar_humanoid": 16, "hopper": 8,
                                       "planar_ant": 8, "swimmer": 8, "arm": 2}[name]


@pytest.mark.parametrize("P, latency", [(1, True), (25, True), (32, True), (43, True),
                                        (97, True), (2112, True), (2113, False),
                                        (32921, False)])
def test_width_rule_follows_the_population(P, latency):
    """HalfCheetah <9, 7, 6, 6> on 132 SMs: the latency instantiation (16
    lanes, 2 trajectories a warp) while its warps fit 8 an SM, 2,112 rows."""
    assert pr.takes_latency(P, (9, 7, 6, 6), 132) is latency


def test_width_rule_scales_with_the_shape_and_the_card():
    # 8 lanes (Hopper <6, 4, 3, 3>): 4 trajectories a warp, 4,224 rows on 132 SMs
    assert pr.takes_latency(4224, (6, 4, 3, 3), 132)
    assert not pr.takes_latency(4225, (6, 4, 3, 3), 132)
    # a card with fewer SMs leaves the latency instantiation sooner
    assert pr.takes_latency(96, (9, 7, 6, 6), 6)
    assert not pr.takes_latency(97, (9, 7, 6, 6), 6)
    # the throughput main path at pop 32,768 and the real step, at every shape
    for shape in ((9, 7, 6, 6), (6, 4, 3, 3), (2, 2, 0, 2), (7, 5, 6, 4), (12, 10, 10, 9),
                  (8, 6, 0, 5)):
        assert not pr.takes_latency(32921, shape, 132)
        assert pr.takes_latency(1, shape, 132)


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
    before = metrics.counters()
    qs, qds = pr.rollout_planar(model, Q, Q, A)
    assert tuple(qs.shape) == tuple(qds.shape) == (3, 4, 9)
    # the CPU runs the plain version and counts no kernel launch
    assert metrics.since(before).get("b1.launches", 0) == 0
