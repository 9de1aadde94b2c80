"""The rate, percentile, idle and roofline arithmetic on synthetic inputs,
and the last line's keys."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, roofline, trace, traffic
from benchmark.tests.conftest import TINY


def test_percentile_and_median_follow_numpy():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == pytest.approx(np.percentile(values, 95))
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.median([1.0, 9.0, 2.0]) == 2.0
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_rate_is_all_steps_over_the_window():
    run = SimpleNamespace(steps=3000, window_s=20.0)
    assert harness.env_steps_per_s(run) == 150.0


def test_host_loop_steps_run_from_one_call_to_the_next():
    rec = traffic.Recorder(plan=None)
    rec.starts = {0: [0.0, 0.010, 0.030], 1: [1.0, 1.004]}
    rec.plans = {0: [0.006, 0.015, 0.005], 1: [0.003, 0.002]}
    assert rec.control_step_ms() == pytest.approx([10.0, 20.0, 4.0])
    assert rec.plan_ms() == pytest.approx([6.0, 15.0, 5.0, 3.0, 2.0])
    assert rec.loop_ms() == pytest.approx([4.0, 5.0, 1.0])
    run = SimpleNamespace(recorder=rec)
    assert harness.control_step_ms_p95(run) == pytest.approx(np.percentile([10, 20, 4], 95))


def test_traced_stretch_leaves_out_its_steps():
    rec = traffic.Recorder(plan=None, trace_steps=(1, 2))
    rec.starts = {0: [0.0, 0.01, 0.02, 0.03, 0.04]}
    rec.plans = {0: [0.005] * 5}
    assert rec.control_step_ms(exclude_traced=True) == pytest.approx([10.0])


def test_union_gaps_and_idle_labels():
    intervals = [(0, 10), (5, 20), (30, 40), (39, 45)]
    assert trace.union_length(intervals, 0, 50) == 35
    assert trace.union_length(intervals, 8, 35) == 17
    assert trace.gaps(intervals, 0, 50) == [(20, 30), (45, 50)]
    host = [("cudaStreamSynchronize", 19, 31), ("aten::copy_", 24, 26), ("outer", 0, 50)]
    labels = trace.label_gaps([(20, 30), (45, 50)], host)
    assert labels == {"aten::copy_": 10, "outer": 5}


def test_reduce_counts_ops_syncs_and_busy_time():
    device = [("planar_rollout_kernel<9, 7, 6, 6>", 0, 600), ("Memcpy DtoD", 700, 710),
              ("planar_rollout_kernel<9, 7, 6, 6>", 800, 1400)]
    host = [("cudaGraphLaunch", 0, 5), ("cudaStreamSynchronize", 1400, 1500),
            ("cudaDeviceSynchronize", 1900, 2000)]
    s = trace.reduce(device, host, window_s=0.002, steps=2, lo=0, hi=2000, host_hi=1900)
    assert s["busy_s"] == pytest.approx(1210e-6)
    # the closing synchronisation (from host_hi on) is not the stretch's
    assert s["device_ops"] == 3 and s["host_syncs"] == 1
    assert s["device_time_by_name"]["planar_rollout_kernel<9, 7, 6, 6>"] == pytest.approx(1.2e-3)
    assert s["breakdown"]["device_ops"][0][0].startswith("planar_rollout_kernel")
    assert len(s["breakdown"]["idle_gaps"]) <= 10
    idle = sum(v for _, v in s["breakdown"]["idle_gaps"])
    assert idle == pytest.approx((2000 - 1210) * 1e-6)


def test_rollouts_and_bounds_of_a_control_step():
    cfg = harness.config("halfcheetah_running.i-cem-blitz")
    shapes = roofline.rollouts_per_control_step(cfg["settings"]["controller_params"])
    assert shapes == [(43, 30), (32, 30), (25, 30), (1, 1)]
    ops = 18894 * (100 * 30 + 1)
    assert roofline.control_step_ops(cfg) == ops
    bound = sum(max(18894 * P * h / 67e12, 4 * (18 * P + 6 * P * h + 18 * h * P) / 3.35e12)
                for P, h in shapes)
    assert roofline.control_step_bound_s(cfg) == pytest.approx(bound)
    tr = {"steps": 400, "window_s": 400 * 6.8e-3, "busy_s": 2.6,
          "device_time_by_name": {"planar_rollout_kernel<9,7,6,6>": 400 * 6.2e-3, "x": 1.0}}
    run = SimpleNamespace(config=cfg, trace=tr, capture_s=1.5, path="device", recorder=None)
    share = harness.metric_reader("b1_roofline_share").read(run)
    assert share == pytest.approx(100 * bound / 6.2e-3)
    assert harness.metric_reader("b2_roofline_share").read(run) is None
    assert harness.metric_reader("step_mfu").read(run) == pytest.approx(
        100 * ops / (6.8e-3 * 67e12))
    assert harness.metric_reader("device_idle_share.episodes").read(run) == pytest.approx(
        100 * (1 - 2.6 / 2.72))
    assert harness.metric_reader("device_idle_share.host_loop").read(run) is None
    assert harness.metric_reader("capture_s").read(run) == 1.5


def test_a_kernel_absent_from_the_trace_reads_nothing():
    cfg = harness.config("humanoid_standup.i-cem-blitz")
    run = SimpleNamespace(config=cfg, trace={"steps": 10, "window_s": 1.0,
                                             "device_time_by_name": {"other": 1.0}})
    assert harness.metric_reader("b2_roofline_share").read(run) is None


def test_the_last_line_keys_on_a_tiny_cpu_run():
    r = harness.run_cell("cheetah_blitz.episodes", 2**31 + 11, 0.0, False, "cpu",
                         overrides=TINY, log=lambda m: None)
    line = {k: v for k, v in r.items() if not k.startswith("_")}
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["attempted"] == 6 and line["failed"] == 0


def test_device_work_after_the_host_reached_the_closing_mark_counts():
    # the host enqueues ahead: its closing mark starts at 100 while the
    # device still works until 180; the mark's end (190) closes the stretch
    device = [("k", 0, 90), ("k", 95, 180)]
    host = [("cudaGraphLaunch", 0, 2), ("cudaDeviceSynchronize", 100, 190)]
    s = trace.reduce(device, host, window_s=190e-6, steps=2, lo=0, hi=190, host_hi=100)
    assert s["busy_s"] == pytest.approx(175e-6)
    assert s["host_syncs"] == 0
