"""icem_torch's store of spans and counters (``runtime/metrics.py``) on the
CPU: spans off unless traced, their nesting and self times, their clock
against torch's profiler, counters through compiled steps, the phase
markers' arithmetic, and the spans the episode runtime, the controller and
the compiled steps record. The markers' kernel and the graphs' marker nodes
are tested on the card (``tests/test_torch_cuda.py``).
"""

import time

import numpy as np
import pytest
import torch

from icem_torch.controllers.icem import MpcICem
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.models.ground_truth import GroundTruthModel
from icem_torch.runtime import graphs, metrics
from icem_torch.runtime.graphs import Compiled
from icem_torch.runtime.rollout import RolloutManager


@pytest.fixture
def store():
    """A clean store with the switch off, left clean."""
    metrics.tracing(False)
    metrics.reset()
    yield metrics
    metrics.tracing(False)
    metrics.reset()


def test_an_inactive_span_is_the_shared_no_op_and_records_nothing(store):
    assert not metrics.active()
    assert metrics.span("a") is metrics.span("b")
    assert metrics.phase("plan.noise", "cpu") is metrics.span("a")
    with metrics.span("a"), metrics.phase("env.step", torch.device("cpu")):
        metrics.mark_step(torch.device("cpu"))
    assert metrics.spans() == []


def test_active_spans_nest_with_their_parents_steps_and_self_times(store):
    metrics.tracing(True)
    assert metrics.active()
    with metrics.span("outer"):
        with metrics.span("a"):
            time.sleep(0.002)
        with metrics.span("b"):
            with metrics.span("c"):
                time.sleep(0.001)
    with metrics.span("next"):
        pass
    records = metrics.spans()
    assert [(r.name, r.parent, r.step) for r in records] == [
        ("outer", None, 0), ("a", 0, 0), ("b", 0, 0), ("c", 2, 0), ("next", None, 4)]
    for r in records:
        assert r.end_ns >= r.start_ns
    dur = [r.end_ns - r.start_ns for r in records]
    own = list(dur)  # self time: the span's duration less its children's
    for r in records:
        if r.parent is not None:
            own[r.parent] -= r.end_ns - r.start_ns
    assert own == [dur[0] - dur[1] - dur[2], dur[1], dur[2] - dur[3], dur[3], dur[4]]
    assert dur[1] >= 2_000_000 and own[0] >= 0
    assert metrics.reset() == records and metrics.spans() == []


def test_a_span_opened_before_tracing_is_not_recorded(store):
    with metrics.span("before"):
        metrics.tracing(True)
        with metrics.span("inner"):
            pass
    assert [(r.name, r.parent) for r in metrics.spans()] == [("inner", None)]


def test_a_span_starts_where_the_profiler_sees_it_start(store):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.active()
        with metrics.span("first"):  # the profiler's first event of the profile
            pass
        for i in range(5):
            with metrics.span(f"clock.{i}"):
                torch.ones(8).sum()
    assert not metrics.active()
    seen = {ev.name(): (ev.start_ns(), ev.end_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CPU and ev.name().startswith("clock.")}
    records = metrics.spans()[1:]
    assert [r.name for r in records] == [f"clock.{i}" for i in range(5)]
    for r in records:
        start, end = seen[r.name]
        assert abs(r.start_ns - start) < 50_000, (r.name, r.start_ns - start)
        # the record closes before the profiler's range does
        assert r.start_ns <= r.end_ns <= end


def test_counters_add_and_replays_add_what_their_capture_counted(store):
    def fn(x):
        metrics.count("toy.launches")
        metrics.count("toy.rows", x.shape[0])
        return x * 2

    step = Compiled(fn, name="toy")
    before = metrics.counters()
    x = torch.ones(5)
    step(x)
    assert metrics.since(before)["toy.rows"] == 5 and metrics.counter("toy.launches") > 0
    (entry,) = step._entries.values()

    class Replayed:
        """What a captured graph is to ``_run``: a replay runs nothing in
        Python."""

        def replay(self):
            pass

    entry.graph = Replayed()
    entry.flats, entry.layout = graphs._pack(fn(*entry.args))
    entry.counts = metrics.since({"toy.launches": 2, "toy.rows": 10, "toy.same": 1},
                                 {"toy.launches": 3, "toy.rows": 15, "toy.same": 1})
    assert entry.counts == {"toy.launches": 1, "toy.rows": 5}
    before = metrics.counters()
    for _ in range(4):
        torch.testing.assert_close(step(x), 2 * x)
    grown = metrics.since(before)
    assert grown["toy.launches"] == 4 and grown["toy.rows"] == 20
    assert grown["graphs.replays"] == 4


def test_the_capture_seconds_stay_the_stores(store):
    assert graphs.CAPTURE_SECONDS == metrics.counter("graphs.capture_s")


def test_phase_times_come_from_consecutive_stamps():
    ids = {name: i for i, name in enumerate(metrics.PHASES)}
    ms = 1_000_000
    stamps = []
    # a stray phase stamp before any step, then two steps
    for name, t in [("env.step", 0), ("step", 10 * ms), ("plan.noise", 11 * ms),
                    ("plan.rollout", 14 * ms), ("plan.select", 15 * ms),
                    ("env.step", 17 * ms), ("step", 20 * ms), ("plan.noise", 22 * ms),
                    ("plan.rollout", 23 * ms), ("plan.select", 23 * ms + 500_000),
                    ("plan.noise", 24 * ms), ("env.step", 30 * ms)]:
        stamps += [ids[name], t]
    per = metrics.phase_ms(stamps)
    assert per == {"plan.noise": [1.0, 2.5], "plan.rollout": [3.0, 1.0],
                   "plan.select": [1.0, 0.5], "env.step": [2.0, 6.0]}
    assert metrics.device_phases() is None  # no marker ran on this machine


def _cheetah_planner():
    env = HalfCheetah(exclude_current_positions_from_observation=False)
    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=4,
                   num_simulated_trajectories=8, seed=3, device="cpu",
                   action_sampler_params=dict(elites_size=3, opt_iterations=3))
    return env, ctrl


def test_the_host_loop_records_its_steps_read_backs_and_replays(store):
    env, ctrl = _cheetah_planner()
    manager = RolloutManager(env, dict(task_horizon=3, fuse_on_device=False), device="cpu")
    before = metrics.counters()
    metrics.tracing(True)
    manager.sample(ctrl, mode="train", no_rollouts=1)
    metrics.tracing(False)
    records = metrics.spans()
    steps = [i for i, r in enumerate(records) if r.name == "rollout.step"]
    assert len(steps) == 3
    for i in steps:
        under = [r for r in records if r.step == i]
        names = [r.name for r in under]
        assert names.count("icem.get_action") == 1 and names.count("icem.readback.action") == 1
        for site in ("next_obs", "obs", "reward_done", "done"):
            assert names.count(f"rollout.readback.{site}") == 1
        assert "graphs.replay:HalfCheetah.step" in names
        assert any(n.startswith("graphs.replay:") and "plan" in n for n in names)
        phases = [n for n in names if n.startswith("plan.")]
        assert phases == ["plan.noise", "plan.rollout", "plan.select"] * 3
        get_action = names.index("icem.get_action")
        assert under[names.index("icem.readback.action")].parent == i + get_action
    assert metrics.since(before).get("b1.launches", 0) == 0  # the CPU runs the plain version


def test_the_device_control_step_records_its_phases_inside_its_replay(store):
    env, ctrl = _cheetah_planner()
    manager = RolloutManager(env, dict(task_horizon=2, fuse_on_device=True), device="cpu")
    metrics.tracing(True)
    manager.sample(ctrl, mode="train", no_rollouts=1)
    metrics.tracing(False)
    records = metrics.spans()
    roots = [i for i, r in enumerate(records) if r.parent is None]
    assert [records[i].name for i in roots] == ["graphs.replay:MpcICem control step"] * 2
    for i in roots:
        names = [r.name for r in records if r.step == i]
        assert names[-1] == "env.step"
        assert [n for n in names if n.startswith("plan.")] == \
            ["plan.noise", "plan.rollout", "plan.select"] * 3
    per_step = np.diff([records[i].start_ns for i in roots])
    assert (per_step > 0).all()
