"""Reduction of a profiled stretch of control steps to the device's busy
time, its idle gaps, its operations and the host's waits.

``summarize`` takes ``torch.profiler``'s raw events of the stretch: device
events (kernels, copies, sets; replays of a CUDA graph show each of its
kernels) and host events (operators and CUDA runtime calls). The stretch
runs from the profiler's start to the end of the ``END_MARK`` range that
closes it, a synchronisation: the host runs ahead of the device, so the
device's work of the stretch ends inside that range. Host events from the
mark on are the closing synchronisation and do not count.
"""

from __future__ import annotations

from collections import defaultdict

END_MARK = "benchmark.stretch_end"
# CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol",
              "cudaStreamWaitEvent_blocking")
IDLE_LABEL = "host: no traced operation"


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def label_gaps(idle, host_events) -> dict:
    """Idle time by what the host was doing: the innermost host event that
    covers each gap's midpoint names it."""
    by_label = defaultdict(float)
    spans = sorted(host_events, key=lambda ev: ev[1])
    for s, e in idle:
        mid = 0.5 * (s + e)
        best = None
        for name, hs, he in spans:
            if hs > mid:
                break
            if he >= mid and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        by_label[best[0] if best else IDLE_LABEL] += e - s
    return by_label


def reduce(device_events, host_events, window_s: float, steps: int, lo: float, hi: float,
           host_hi: float | None = None) -> dict:
    """``device_events`` and ``host_events``: (name, start, end) in
    microseconds; ``[lo, hi)`` the stretch on the profiler's clock, whose
    host events end at ``host_hi`` (default ``hi``); ``window_s`` its length
    on the host clock, over ``steps`` control steps."""
    host_hi = hi if host_hi is None else host_hi
    intervals = [(s, e) for _, s, e in device_events]
    busy_us = union_length(intervals, lo, hi)
    by_name = defaultdict(float)
    for name, s, e in device_events:
        by_name[name] += (e - s) * 1e-6
    host = [(n, s, e) for n, s, e in host_events if s < host_hi]
    syncs = sum(1 for n, _, _ in host if n in SYNC_CALLS)
    idle = label_gaps(gaps(intervals, lo, hi), host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(((k, v * 1e-6) for k, v in idle.items()), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "steps": steps,
            "device_ops": len(device_events), "host_syncs": syncs,
            "device_time_by_name": dict(by_name),
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in longest]}}


def summarize(profiler, window_s: float, steps: int) -> dict:
    """``reduce`` over a stopped ``torch.profiler.profile``'s raw events
    (the profiler's own event tree is not built: it takes minutes over a
    few hundred steps of graph replays)."""
    from torch.autograd import DeviceType

    device, host, lo, mark = [], [], None, None
    for ev in profiler.profiler.kineto_results.events():
        s, e = ev.start_ns() * 1e-3, ev.end_ns() * 1e-3
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, s, e))
        elif name == END_MARK:
            mark = (s, e)
        else:
            host.append((name, s, e))
        lo = s if lo is None else min(lo, s)
    if mark is None:
        end = max([e for _, _, e in device + host], default=lo or 0.0)
        mark = (end, end)
    return reduce(device, host, window_s, steps, lo or 0.0, mark[1], host_hi=mark[0])
