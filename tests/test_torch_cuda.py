"""The rollout kernels' launch paths on a CUDA card.

These tests need the card and skip without one. On a machine with an H100
and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from icem_torch.envs import env_from_string
from icem_torch.envs.ant3d import Ant3D
from icem_torch.envs.cheetah import HalfCheetah, make_cheetah_model
from icem_torch.envs.humanoid3d import HumanoidStandup3D
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.ops import planar_rollout as pr
from icem_torch.ops import spatial_rollout as sr
from icem_torch.runtime import metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(P, h, device, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-0.1, 0.1, (P, 9)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, 9))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, 6)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (Q, QD, A)]


@pytest.mark.parametrize("P", [1, 127, 1000])
def test_kernel_matches_plain_version(cuda, P):
    model = make_cheetah_model(dt=0.05, n_substeps=20)
    Q, QD, A = _inputs(P, 3, cuda)
    before = metrics.counter("b1.launches")
    qs, qds = pr.rollout_planar(model, Q, QD, A)
    torch.cuda.synchronize()
    assert metrics.counter("b1.launches") == before + 1
    rq, rqd = pr.rollout_planar_reference(model, Q, QD, A)
    # tests/test_pallas_rollout.py's tolerance over the first three steps
    torch.testing.assert_close(qs, rq, atol=1e-3, rtol=0)
    assert bool(torch.isfinite(qds).all())


def test_kernel_reads_strided_rows(cuda):
    """The env passes Q and QD as column slices of its [P, 2 nd] state."""
    model = make_cheetah_model(dt=0.05, n_substeps=20)
    Q, QD, A = _inputs(127, 3, cuda)
    S = torch.cat([Q, QD], dim=1)
    Qv, QDv = S[:, :9], S[:, 9:]
    assert Qv.stride(0) == QDv.stride(0) == 18
    qs, qds = pr.rollout_planar(model, Qv, QDv, A)
    qs_c, qds_c = pr.rollout_planar(model, Q, QD, A)
    assert torch.equal(qs, qs_c) and torch.equal(qds, qds_c)


def test_env_step_is_one_launch(cuda):
    env = HalfCheetah(exclude_current_positions_from_observation=True)
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    before = metrics.counter("b1.launches")
    new_state, obs, reward, done = env.step(state, torch.zeros(6, device=cuda))
    assert metrics.counter("b1.launches") == before + 1
    assert new_state.device.type == "cuda" and tuple(obs.shape) == (17,)


def test_kernel_raises_on_what_it_does_not_take(cuda):
    model = make_cheetah_model()
    Q, QD, A = _inputs(8, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        pr.rollout_planar(model, Q.double(), QD.double(), A)
    with pytest.raises(ValueError, match="on cpu"):
        pr.rollout_planar(model, Q, QD.cpu(), A)
    # a three-link arm: no env has this shape, so the kernel has no instantiation
    arm = PlanarModel(parent=(-1, 0, 1), anchor=np.zeros((3, 2), np.float32),
                      com=np.zeros((3, 2), np.float32), mass=np.ones(3, np.float32),
                      inertia=np.ones(3, np.float32), free_root=False,
                      actuator_dof=(0, 1, 2), gear=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="not instantiated"):
        pr.rollout_planar(arm, torch.zeros(8, 3, device=cuda), torch.zeros(8, 3, device=cuda),
                          torch.zeros(8, 2, 3, device=cuda))


# the other planar shapes: one env each, through the registry
PLANAR = {"Hopper": dict(exclude_current_positions_from_observation=False),
          "Reacher": {}, "PlanarAnt": dict(exclude_current_positions_from_observation=False),
          "PlanarHumanoidStandup": {}, "swimmer": {}, "cheetah": {}}


def _planar_inputs(env, P, h, device, seed=0):
    """States near the env's start distribution as the env passes them
    (column slices of one state tensor), and uniform actions."""
    model = env.model
    n, na = model.ndof, len(model.actuator_dof)
    gen = torch.Generator(device=device).manual_seed(seed)
    S = torch.stack([env.init_state(gen) for _ in range(8)])[torch.arange(P) % 8]
    S[:, :n] += 0.05 * torch.randn(P, n, generator=gen, device=device)
    S[:, n:2 * n] += 0.1 * torch.randn(P, n, generator=gen, device=device)
    A = torch.rand(P, h, na, generator=gen, device=device) * 2 - 1
    return S[:, :n], S[:, n:2 * n], A


@pytest.mark.parametrize("name", list(PLANAR))
@pytest.mark.parametrize("P", [1, 127])
def test_every_planar_shape_matches_plain_version(cuda, name, P):
    env = env_from_string(name, **PLANAR[name])
    Q, QD, A = _planar_inputs(env, P, 2, cuda)
    before = metrics.counter("b1.launches")
    qs, qds = pr.rollout_planar(env.model, Q, QD, A)
    torch.cuda.synchronize()
    assert metrics.counter("b1.launches") == before + 1
    rq, _ = pr.rollout_planar_reference(env.model, Q, QD, A)
    assert bool(torch.isfinite(qs).all() and torch.isfinite(qds).all())
    torch.testing.assert_close(qs, rq, atol=1e-3, rtol=0)
    # the rows at the state's stride give the bits of contiguous copies
    qs_c, qds_c = pr.rollout_planar(env.model, Q.contiguous(), QD.contiguous(), A)
    assert torch.equal(qs, qs_c) and torch.equal(qds, qds_c)


@pytest.mark.parametrize("name", list(PLANAR))
def test_every_planar_env_step_is_one_launch(cuda, name):
    env = env_from_string(name, **PLANAR[name])
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    before = metrics.counter("b1.launches")
    new_state, obs, reward, done = env.step(state, torch.zeros(env.action_dim, device=cuda))
    assert metrics.counter("b1.launches") == before + 1
    assert new_state.device.type == "cuda" and tuple(obs.shape) == (env.obs_dim,)


# -- B1's two instantiations: throughput (G = 2) and latency (a lane per item)

def _crossover(model) -> int:
    """The largest P that takes the latency instantiation on this card."""
    shape, sms = pr.kernel_shape(model), pr._sm_count(torch.cuda.current_device())
    P = 1
    while pr.takes_latency(P + 1, shape, sms):
        P += 1
    return P


@pytest.mark.parametrize("name", ["cheetah", "PlanarHumanoidStandup"])
@pytest.mark.parametrize("P", [1, 25, 32, 43, "last latency", "first throughput"])
def test_both_widths_give_the_same_bits(cuda, name, P):
    """Each phase computes an item with the same expression whichever lane
    takes it, so both instantiations give the same states at the planner's
    rows, the real step's and either side of the rule's crossover; and
    ``rollout_planar`` launches the one the rule picks."""
    from icem_torch.ops._build import load_library

    env = env_from_string(name, **PLANAR[name])
    if isinstance(P, str):
        P = _crossover(env.model) + (P == "first throughput")
    Q, QD, A = _planar_inputs(env, P, 30, cuda)
    lib = load_library()[0]
    out = [pr.launch_bound(pr.bind(lib, env.model, w), Q, QD, A)
           for w in (pr.THROUGHPUT, pr.LATENCY)]
    torch.cuda.synchronize()
    (qs, qds), (qs_l, qds_l) = out
    assert bool(torch.isfinite(qs).all() and torch.isfinite(qds).all())
    assert torch.equal(qs_l, qs) and torch.equal(qds_l, qds)
    before = metrics.counters()
    qs_r, _ = pr.rollout_planar(env.model, Q, QD, A)
    grown = metrics.since(before)
    latency = pr.takes_latency(P, pr.kernel_shape(env.model), pr._sm_count(cuda.index or 0))
    assert grown.get("b1.launches.latency", 0) == int(latency) and grown["b1.launches"] == 1
    assert torch.equal(qs_r, qs)


def test_latency_launches_are_counted(cuda):
    """An i-cem-blitz control step launches B1 at 43 / 32 / 25 rows and the
    real step's one, all four on the latency instantiation; the main path's
    32,921 rows take the throughput one."""
    step, args = _blitz_control_step(cuda)
    before = metrics.counters()
    step(*args)
    torch.cuda.synchronize()
    grown = metrics.since(before)
    assert grown["b1.launches"] == 4 and grown["b1.launches.latency"] == 4
    model = make_cheetah_model(dt=0.05, n_substeps=20)
    Q, QD, A = _inputs(32921, 2, cuda)
    before = metrics.counters()
    pr.rollout_planar(model, Q, QD, A)
    grown = metrics.since(before)
    assert grown["b1.launches"] == 1 and "b1.launches.latency" not in grown


# ---------------------------------------------------------------------------
# the spatial rollout kernel (B2)

SPATIAL = {"ant3d": Ant3D, "humanoid3d": HumanoidStandup3D}


def _spatial_inputs(env, P, h, device, seed=0):
    """States near the env's start distribution, as the env passes them
    (column slices of one state tensor), and uniform actions."""
    model = env.model
    n, na = model.ndof, len(model.actuator_dof)
    gen = torch.Generator(device=device).manual_seed(seed)
    S = torch.stack([env.init_state(gen) for _ in range(8)])[torch.arange(P) % 8]
    S[:, :n] += 0.05 * torch.randn(P, n, generator=gen, device=device)
    S[:, n:2 * n] += 0.1 * torch.randn(P, n, generator=gen, device=device)
    A = torch.rand(P, h, na, generator=gen, device=device) * 2 - 1
    return S[:, :n], S[:, n:2 * n], A


@pytest.mark.parametrize("name", list(SPATIAL))
@pytest.mark.parametrize("P", [1, 127, 1000])
def test_spatial_kernel_matches_plain_version(cuda, name, P):
    env = SPATIAL[name]()
    Q, QD, A = _spatial_inputs(env, P, 3, cuda)
    before = metrics.counter("b2.launches")
    qs, qds = sr.rollout_spatial(env.model, Q, QD, A)
    torch.cuda.synchronize()
    assert metrics.counter("b2.launches") == before + 1
    rq, _ = sr.rollout_spatial_reference(env.model, Q, QD, A)
    assert bool(torch.isfinite(qs).all() and torch.isfinite(qds).all())
    # tests/test_pallas_rollout.py's spatial bulk rule over three steps
    d = (qs - rq).abs()
    assert float(torch.quantile(d.flatten(), 0.999)) < 1e-3 and float(d.max()) < 5e-2


@pytest.mark.parametrize("name", list(SPATIAL))
def test_spatial_kernel_reads_strided_rows(cuda, name):
    env = SPATIAL[name]()
    Q, QD, A = _spatial_inputs(env, 127, 3, cuda)
    assert Q.stride(0) == QD.stride(0) == 2 * env.model.ndof
    qs, qds = sr.rollout_spatial(env.model, Q, QD, A)
    qs_c, qds_c = sr.rollout_spatial(env.model, Q.contiguous(), QD.contiguous(), A)
    assert torch.equal(qs, qs_c) and torch.equal(qds, qds_c)


def test_spatial_env_step_is_one_launch(cuda):
    env = Ant3D(exclude_current_positions_from_observation=False)
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    before = metrics.counter("b2.launches")
    new_state, obs, reward, done = env.step(state, torch.zeros(8, device=cuda))
    assert metrics.counter("b2.launches") == before + 1
    assert new_state.device.type == "cuda" and tuple(obs.shape) == (28,)


def test_spatial_kernel_raises_on_what_it_does_not_take(cuda):
    model = Ant3D().model
    Q, QD, A = _spatial_inputs(Ant3D(), 8, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        sr.rollout_spatial(model, Q.double(), QD.double(), A)
    with pytest.raises(ValueError, match="on cpu"):
        sr.rollout_spatial(model, Q, QD.cpu(), A)
    chain = SpatialModel(parent=(-1, 0), anchor=np.zeros((2, 3), np.float32),
                         axis=np.eye(3, dtype=np.float32)[:2],
                         com=np.zeros((2, 3), np.float32), mass=np.ones(2, np.float32),
                         inertia=np.ones((2, 3), np.float32), free_root=False,
                         actuator_dof=(0, 1), gear=np.ones(2, np.float32))
    with pytest.raises(ValueError, match="not instantiated"):
        sr.rollout_spatial(chain, torch.zeros(8, 2, device=cuda),
                           torch.zeros(8, 2, device=cuda), torch.zeros(8, 2, 2, device=cuda))


# -- the compiled step: CUDA graphs against eager dispatch ---------------------

def _launches(before: dict) -> tuple:
    """B1's and B2's launches since the counters' snapshot ``before``."""
    grown = metrics.since(before)
    return grown.get("b1.launches", 0), grown.get("b2.launches", 0)


def _icem_steps(env, cuda, steps: int, eager: bool):
    """``steps`` MpcICem control steps on ``env`` from one seeded start:
    (actions, means, stds, the kernels' launches, the plan step's graphs)."""
    import contextlib

    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.runtime.graphs import disable_graphs

    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=10,
                   num_simulated_trajectories=64, seed=3, device=cuda,
                   action_sampler_params=dict(elites_size=8, opt_iterations=3))
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    obs = env.observation(state)
    before = metrics.counters()
    out = []
    with disable_graphs() if eager else contextlib.nullcontext():
        ctrl.beginning_of_rollout(observation=obs, state=state)
        for _ in range(steps):
            a = ctrl.get_action(obs, state)
            out.append((a, ctrl._pstate.mean.cpu().numpy(), ctrl._pstate.std.cpu().numpy()))
            state, obs, _, _ = env.step(state, torch.as_tensor(a, device=cuda))
    return out, _launches(before), ctrl._plan_impl().num_keys


@pytest.mark.parametrize("loop", ["unrolled", "scan"])
def test_compiled_plan_steps_give_the_eager_bits_and_launches(cuda, loop):
    """MpcICem replays CUDA graphs by default: HalfCheetah through kernel B1
    (the unrolled loop), Ant3D through B2 (the scanned loop); the same bits
    and the same launch counts as the same steps run eagerly."""
    from icem_torch.runtime import graphs

    env = (HalfCheetah(exclude_current_positions_from_observation=True) if loop == "unrolled"
           else Ant3D(exclude_current_positions_from_observation=False))
    eager, eager_launches, _ = _icem_steps(env, cuda, 6, eager=True)
    replays = metrics.counter("graphs.replays")
    graph, graph_launches, keys = _icem_steps(env, cuda, 6, eager=False)
    # have_elites False, then True
    assert metrics.counter("graphs.replays") - replays == 6 and keys == 2
    assert graph_launches == eager_launches and sum(eager_launches) == 4 * 6
    for (a, m, s), (ga, gm, gs) in zip(eager, graph):
        np.testing.assert_array_equal(ga, a)
        np.testing.assert_array_equal(gm, m)
        np.testing.assert_array_equal(gs, s)


def test_a_host_wait_in_a_captured_step_raises(cuda, monkeypatch):
    """An injected ``.item()`` in the plan step: the capture raises, and
    nothing runs the step eagerly in its place."""
    from icem_torch.controllers import icem as ic

    real = ic.top_k_ascending
    calls = []

    def with_a_host_wait(costs, k):
        calls.append(float(costs.min()))  # Tensor.item: the host waits for the card
        return real(costs, k)

    monkeypatch.setattr(ic, "top_k_ascending", with_a_host_wait)
    env = HalfCheetah(exclude_current_positions_from_observation=True)
    with pytest.raises(RuntimeError, match="CUDA graph capture of MpcICem.plan_step failed"):
        _icem_steps(env, cuda, 1, eager=False)
    # the warm-up's three CEM iterations ran; the capture stopped at the
    # first host wait, and no eager call followed
    assert len(calls) == 3
    assert float(torch.ones(2, device=cuda).sum()) == 2.0  # the card works on


def test_a_graph_the_collector_frees_during_a_capture_leaves_it_whole(cuda):
    """A controller and its compiled steps form a reference cycle, so the
    cyclic collector frees their graphs at whatever allocation comes next,
    even inside another step's capture, where CUDA refuses to destroy a
    kept graph: the capture runs with the collector paused, and the
    unreachable graph goes at the first collection after it."""
    import gc
    import weakref

    from icem_torch.runtime.graphs import Compiled

    class Planner:
        def __init__(self):
            self.step = Compiled(self.double, name="planner")

        def double(self, x):
            return 2 * x

    x = torch.arange(8.0, device=cuda)
    calls = []
    planners = []

    def shift(x):
        calls.append(len(calls))
        if len(calls) == 2:  # the capture, after one warm-up call
            planners.clear()  # the planner's cycle is garbage, and young
            gc.set_threshold(1, 1, 1)  # the next allocation collects the young
            assert sum(len(j) for j in [[i] for i in range(1000)]) == 1000
        return x + 1

    threshold = gc.get_threshold()
    gc.collect()
    gc.set_threshold(10**6, 10**6, 10**6)  # no collection until the capture
    try:
        planners.append(Planner())
        torch.testing.assert_close(planners[0].step(x), 2 * x)  # captured, its graph kept
        gone = weakref.ref(planners[0])
        out = Compiled(shift, name="shift")(x)
    finally:
        gc.set_threshold(*threshold)
    torch.testing.assert_close(out, x + 1)
    assert len(calls) == 2
    gc.collect()
    assert gone() is None


# -- the sharded planner as a compiled step, over the one-rank NCCL group -----

def _sharded_steps(planner, cuda, steps: int, eager: bool, monkeypatch):
    """``steps`` HalfCheetah control steps of a sharded controller (B1) over
    the process's one-rank NCCL group, from one seeded start: (each step's
    action, mean, std and elites, the kernels' launches, the plan body's
    keys, the host waits inside replays)."""
    import contextlib
    import warnings

    from icem_torch.controllers.cem_std import MpcCemStd
    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.runtime import graphs

    waits = []
    real_run = graphs.Compiled._run

    def counted_run(self, entry, tensors, generators):
        if entry.graph is None:
            return real_run(self, entry, tensors, generators)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = real_run(self, entry, tensors, generators)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits.append(sum("synchroniz" in str(w.message) for w in caught))
        return out

    monkeypatch.setattr(graphs.Compiled, "_run", counted_run)
    env = HalfCheetah(exclude_current_positions_from_observation=True)
    cls = MpcICem if planner == "icem" else MpcCemStd
    ctrl = cls(env=env, forward_model=GroundTruthModel(env=env), horizon=10,
               num_simulated_trajectories=64, seed=3, device=cuda, sharded=True,
               action_sampler_params=dict(elites_size=8, opt_iterations=3))
    assert ctrl._group.backend == "nccl" and not ctrl.plans_eagerly
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    obs = env.observation(state)
    before = metrics.counters()
    out = []
    with graphs.disable_graphs() if eager else contextlib.nullcontext():
        ctrl.beginning_of_rollout(observation=obs, state=state)
        for _ in range(steps):
            a = ctrl.get_action(obs, state)
            st = ctrl._pstate
            out.append([a] + [getattr(st, k).cpu().numpy() for k in
                              ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs")
                              if hasattr(st, k)])
            state, obs, _, _ = env.step(state, torch.as_tensor(a, device=cuda))
    assert ctrl._pstate.rank_stream.step == steps
    return out, _launches(before), ctrl._plan_impl().body.num_keys, waits


@pytest.mark.parametrize("planner", ["icem", "cem"])
def test_compiled_sharded_plan_steps_give_the_eager_bits(cuda, planner, monkeypatch):
    """MpcICem and MpcCemStd with sharded=True over the one-rank NCCL group
    replay CUDA graphs with the gather inside: 5 steps give the eager
    sharded planner's actions, means, stds and elites to the bit, with as
    many B1 launches and no host wait inside a replay."""
    from icem_torch.runtime import graphs

    eager, eager_launches, _, _ = _sharded_steps(planner, cuda, 5, True, monkeypatch)
    replays = metrics.counter("graphs.replays")
    graph, graph_launches, keys, waits = _sharded_steps(planner, cuda, 5, False, monkeypatch)
    assert metrics.counter("graphs.replays") - replays == 5
    assert keys == (2 if planner == "icem" else 1)
    assert waits == [0] * 5
    assert graph_launches == eager_launches and sum(eager_launches) == 4 * 5
    for step, (e, g) in enumerate(zip(eager, graph, strict=True)):
        for x, y in zip(e, g, strict=True):
            np.testing.assert_array_equal(y, x, err_msg=f"step {step}")


def test_compiled_sharded_device_episode_gives_the_eager_bits(cuda):
    """A sharded MpcICem's device episode over the one-rank NCCL group: the
    compiled control step (2 keys) gives the eager episode's transitions to
    the bit."""
    import contextlib

    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.runtime import graphs
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding

    def episode(eager):
        Seeding.set_seed(5)
        env = HalfCheetah(exclude_current_positions_from_observation=True)
        ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=10,
                       num_simulated_trajectories=64, seed=3, device=cuda, sharded=True,
                       action_sampler_params=dict(elites_size=8, opt_iterations=3))
        rm = RolloutManager(env, dict(task_horizon=6, use_env_states=True), device=cuda)
        ctx = graphs.disable_graphs() if eager else contextlib.nullcontext()
        with ctx:
            (ep,) = rm.sample_on_device(ctrl)
        return ep, rm._control_step(ctrl).step

    eager, _ = episode(True)
    graph, step = episode(False)
    assert isinstance(step, graphs.Compiled) and step.num_keys == 2
    assert len(graph) == len(eager) == 6
    for k in eager.field_names:
        np.testing.assert_array_equal(graph[k], eager[k], err_msg=k)


# -- the trace's phase markers inside the captured control step ---------------

def _blitz_control_step(cuda):
    """The device episode's compiled control step of HalfCheetah iCEM at the
    shipped i-cem-blitz population (40 / 32 / 25 fresh rows and 3 shifted
    elites, h 30), run once (the first-step key), and the next step's
    inputs."""
    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.runtime.rollout import RolloutManager

    env = HalfCheetah(exclude_current_positions_from_observation=False)
    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=30,
                   num_simulated_trajectories=40, seed=3, device=cuda,
                   action_sampler_params=dict(elites_size=10, opt_iterations=3,
                                              fraction_elites_reused=0.3))
    step = RolloutManager(env, dict(task_horizon=20), device=cuda)._control_step(ctrl)
    state, obs = env.reset_with_mode(torch.Generator(device=cuda).manual_seed(0), "train")
    pstate = ctrl.init_plan_state(env.obs_dim, torch.Generator(device=cuda).manual_seed(1))
    pstate, state, obs, done, _ = step(pstate, state, obs, torch.zeros((), device=cuda), None)
    return step, (pstate, state, obs, done, None)


def _leaves_equal(a, b) -> bool:
    from torch.utils import _pytree as pytree

    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b), strict=True):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            return False
    return True


def test_phase_markers_stay_off_until_traced_and_leave_the_bits(cuda):
    """The captured control step holds 11 markers (a step's, 3 x noise /
    rollout / select, the env step's) as disabled nodes: 10 replays leave
    the ring as it was; with tracing on, 10 replays stamp 110 times in phase
    order; off again, none. The outputs are the same bits either way, and
    B1 counts 4 launches and 43 + 32 + 25 + 1 rows a step."""
    step, args = _blitz_control_step(cuda)
    gen, g0 = args[0].generator, args[0].generator.get_state()

    def replay():
        gen.set_state(g0)
        return step(*args)

    off = replay()  # captures the steady key
    metrics.reset()
    before = metrics.counters()
    for _ in range(10):
        assert _leaves_equal(replay(), off)
    assert metrics.marker_stamps() == []
    grown = metrics.since(before)
    assert grown["b1.launches"] == 40 and grown["b1.rows"] == 10 * (43 + 32 + 25 + 1)
    metrics.tracing(True)
    try:
        for _ in range(10):
            assert _leaves_equal(replay(), off)
    finally:
        metrics.tracing(False)
    stamps = metrics.marker_stamps()
    assert stamps[0::2] == [0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 4] * 10
    assert all(b >= a for a, b in zip(stamps[1::2], stamps[3::2]))
    per = metrics.device_phases()
    assert set(per) == {"plan.noise", "plan.rollout", "plan.select", "env.step"}
    assert all(len(ms) == 10 and min(ms) > 0 for ms in per.values())
    assert _leaves_equal(replay(), off)
    assert len(metrics.marker_stamps()) == 2 * 110
    metrics.reset()


def test_phase_markers_run_eagerly_only_while_traced(cuda):
    from icem_torch.runtime.graphs import disable_graphs

    step, args = _blitz_control_step(cuda)
    metrics.reset()
    with disable_graphs():
        step(*args)
        assert metrics.marker_stamps() == []
        metrics.tracing(True)
        try:
            step(*args)
        finally:
            metrics.tracing(False)
    assert metrics.marker_stamps()[0::2] == [0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 4]
    metrics.reset()
