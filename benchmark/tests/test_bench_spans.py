"""The readers of the program's spans and phase markers, on synthetic
stores: what each reads, and None where the program recorded nothing."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from icem_torch.runtime import metrics
from icem_torch.runtime.metrics import Span

PHASES = {"plan_noise_ms_per_step": "plan.noise", "plan_rollout_ms_per_step": "plan.rollout",
          "plan_select_ms_per_step": "plan.select", "env_step_ms_per_step": "env.step"}
MS = 1_000_000


def _run(path: str, steps: int = 4):
    return SimpleNamespace(path=path, trace={"steps": steps, "window_s": 1.0})


@pytest.mark.parametrize("name", sorted(PHASES))
def test_a_phase_reader_gives_its_phase_ms_per_traced_step(name, monkeypatch):
    per = {"plan.noise": [0.1, 0.2, 0.3, 0.2], "plan.rollout": [6.0, 6.1, 6.2, 6.1],
           "plan.select": [0.2, 0.2, 0.2, 0.2], "env.step": [0.1, 0.1, 0.1, 0.1]}
    monkeypatch.setattr(metrics, "device_phases", lambda: per)
    reader = harness.metric_reader(name)
    assert reader.read(_run("device")) == pytest.approx(sum(per[PHASES[name]]) / 4)
    assert reader.read(_run("host")) is None
    assert reader.read(SimpleNamespace(path="device", trace=None)) is None
    monkeypatch.setattr(metrics, "device_phases", lambda: None)
    assert reader.read(_run("device")) is None
    # a program without phase markers
    monkeypatch.delattr(metrics, "device_phases")
    assert reader.read(_run("device")) is None


def _host_loop_spans():
    """Two traced control steps of the host loop and a partial one before
    them: (name, start ms, end ms, parent, step)."""
    rows = [("graphs.replay:HalfCheetah.step", 0, 1, None, 0),          # partial step
            ("rollout.step", 2, 12, None, 1),
            ("icem.get_action", 2, 9, 1, 1),
            ("graphs.replay:MpcICem.plan_step", 2.5, 3, 2, 1),
            ("icem.readback.action", 3, 8.5, 2, 1),
            ("graphs.replay:HalfCheetah.step", 9, 9.25, 1, 1),
            ("rollout.readback.next_obs", 9.25, 10, 1, 1),
            ("rollout.readback.obs", 10, 10.5, 1, 1),
            ("rollout.step", 12, 20, None, 8),
            ("icem.get_action", 12, 18, 8, 8),
            ("graphs.replay:MpcICem.plan_step", 12.5, 13.5, 9, 8),
            ("icem.readback.action", 13.5, 17, 9, 8),
            ("graphs.replay:HalfCheetah.step", 18, 18.5, 8, 8),
            ("rollout.readback.done", 18.5, 19, 8, 8)]
    return [Span(n, int(a * MS), int(b * MS), p, s) for n, a, b, p, s in rows]


def test_host_work_is_each_step_less_its_blocking_reads(monkeypatch):
    monkeypatch.setattr(metrics, "spans", _host_loop_spans)
    reader = harness.metric_reader("host_work_ms_p50.host_loop")
    # step 1: 10 - 5.5 - 0.75 - 0.5 = 3.25; step 8: 8 - 3.5 - 0.5 = 4.0
    assert reader.read(_run("host")) == pytest.approx((3.25 + 4.0) / 2)
    assert reader.read(_run("device")) is None
    monkeypatch.setattr(metrics, "spans", lambda: [])
    assert reader.read(_run("host")) is None
    monkeypatch.delattr(metrics, "spans")
    assert reader.read(_run("host")) is None


def test_graph_launch_time_sums_the_replays_of_each_step(monkeypatch):
    monkeypatch.setattr(metrics, "spans", _host_loop_spans)
    reader = harness.metric_reader("graph_launch_ms_p50.host_loop")
    # step 1: 0.5 + 0.25; step 8: 1.0 + 0.5; the partial step is left out
    assert reader.read(_run("host")) == pytest.approx((0.75 + 1.5) / 2)
    assert reader.read(_run("device")) is None
    monkeypatch.setattr(metrics, "spans", lambda: [])
    assert reader.read(_run("host")) is None
    monkeypatch.delattr(metrics, "spans")
    assert reader.read(_run("host")) is None


def test_the_host_loop_readers_read_a_real_store():
    """The readers over the spans a tiny host-loop episode records on the
    CPU: every traced step has host work and a graph call."""
    from benchmark.tests.conftest import TINY

    bench = harness.manifest()
    w = harness.workload("cheetah_blitz.host_loop", bench)
    _, _, controller, manager = harness.build(harness.config(w["config"]),
                                              harness.mix(w["traffic"]), 3, "cpu",
                                              overrides=TINY)
    metrics.reset()
    metrics.tracing(True)
    try:
        manager.sample(controller, mode="train", no_rollouts=1)
    finally:
        metrics.tracing(False)
    run = _run("host")
    work = harness.metric_reader("host_work_ms_p50.host_loop").read(run)
    launch = harness.metric_reader("graph_launch_ms_p50.host_loop").read(run)
    metrics.reset()
    assert work > 0 and launch > 0
