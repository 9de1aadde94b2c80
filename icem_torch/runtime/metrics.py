"""Metrics / logging / observability.

Counterpart of ``icem_tpu/runtime/metrics.py``: scoped loggers, per-key step
counters, an always-on machine-readable ``metrics.jsonl`` stream, TensorBoard
events where ``torch.utils.tensorboard`` imports, and a device trace from
``torch.profiler`` (``jax.profiler`` in the JAX package).

Beside the logger, one store of spans and counters for the whole process:

- ``span(name)``: a host span at a layer boundary. Tracing is active while
  ``torch.profiler`` runs or the store's own switch is on
  (``tracing(True)``); inactive, ``span`` returns one shared no-op context.
  Active, the span is a range of the profiler's host timeline and a record
  ``(name, start_ns, end_ns, parent, step)`` in memory, stamped with
  ``time.time_ns()``, the clock of the profiler's host events. ``parent``
  is the index of the enclosing recorded span, ``step`` that of its
  outermost one. Records stay in memory until ``spans()`` or ``reset()``
  reads them.
- ``count(name, n)``: always on, one dict update; ``counters()`` is a
  snapshot. The kernels count ``b1.launches`` / ``b1.rows`` (and
  ``b1.launches.latency``, the launches of B1's latency instantiation) and
  ``b2.launches`` / ``b2.rows``, the compiled steps ``graphs.captures``,
  ``graphs.capture_s`` and ``graphs.replays`` (a replay adds what its
  capture counted).
- ``phase(name, device)`` and ``mark_step(device)``: phase markers inside
  the control step. A marker is a one-thread kernel
  (``csrc/trace_mark.cu``) that stamps (phase id, the device's global
  timer) into a device ring. Markers are launched while a graph is being
  captured, and eagerly only while tracing is active; never on the CPU. A
  captured graph keeps them as disabled nodes, which ``Compiled`` enables
  while tracing is active (``runtime/graphs.py``). ``device_phases()``
  turns the ring's stamps into device ms per phase per control step.

Spans and counters are kept for one thread: the control loop's.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler


class MetricsLogger:
    """Scoped metric logger with per-key step counters.

    TensorBoard events are written when torch.utils.tensorboard is available;
    a metrics.jsonl stream is always written.
    """

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.step_per_key = {}
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(logdir, "tb"))
            except ImportError:
                self._tb = None

    def log(self, value, key: str, step: Optional[int] = None, scope: str = ""):
        full_key = f"{scope}/{key}" if scope else key
        if step is None:
            step = self.step_per_key.get(full_key, 0)
            self.step_per_key[full_key] = step + 1
        value = float(value)
        self._jsonl.write(json.dumps(
            {"key": full_key, "value": value, "step": step, "t": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(full_key, value, step)

    def info(self, msg: str):
        print(msg, flush=True)

    @contextlib.contextmanager
    def device_trace(self, trace_dir: Optional[str] = None):
        """Trace a block with torch.profiler, the card too where there is one,
        into ``<trace_dir>/trace.json`` (Chrome trace format). Tracing is
        active inside: the program's spans are ranges of the trace, its
        phase markers kernels named ``trace_mark_kernel``. The store's spans
        and marker stamps are reset first: afterwards they hold this
        block's."""
        from torch.profiler import ProfilerActivity, profile

        out = trace_dir or os.path.join(self.logdir, "traces")
        os.makedirs(out, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        reset()
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    def close(self):
        """Close the streams; a later get_logger of this logdir opens a new
        logger that appends to them."""
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if _LOGGERS.get(self.logdir) is self:
            del _LOGGERS[self.logdir]


_LOGGERS = {}


def get_logger(logdir: str = "results/default", scope: str = "",
               use_tensorboard: bool = True) -> MetricsLogger:
    if logdir not in _LOGGERS:
        _LOGGERS[logdir] = MetricsLogger(logdir, use_tensorboard)
    return _LOGGERS[logdir]


# ---------------------------------------------------------------------------
# the store: spans, counters, phase markers


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]     # None while the span is open
    parent: Optional[int]     # index of the enclosing recorded span
    step: int                 # index of the outermost recorded span around it


# the phases of a control step, by marker id: a "step" marker opens a
# control step, every other marker closes the phase of its name
PHASES = ("step", "plan.noise", "plan.rollout", "plan.select", "env.step")
_PHASE_ID = {name: i for i, name in enumerate(PHASES)}

_NULL = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast
_state = threading.local()
_switch = False
_records: list = []           # [name, start_ns, end_ns, parent, step]
_open: list = []              # (index, record) of the recorded spans now open
_counters: dict = {}


def tracing(on: bool):
    """Turn the store's own switch on or off: tracing without a profiler."""
    global _switch
    _switch = bool(on)


def active() -> bool:
    """Whether tracing is active: the switch is on or torch's profiler runs."""
    return _switch or _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "_range", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # a function-scope range: the profiler keeps it on the host timeline
        # only (a user-scope range, record_function's, also gets an
        # annotation on the device timeline over the work launched in it)
        self._range = _RANGE(self.name)
        self._range.__enter__()
        parent = _open[-1][0] if _open else None
        step = _records[parent][4] if parent is not None else len(_records)
        self._record = [self.name, time.time_ns(), None, parent, step]
        _open.append((len(_records), self._record))
        _records.append(self._record)
        return self

    def __exit__(self, *exc):
        self._record[2] = time.time_ns()
        if _open and _open[-1][1] is self._record:
            _open.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A host span named ``name`` (see the module); a shared no-op while
    tracing is inactive."""
    if not (_switch or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def spans() -> list:
    """The recorded spans, in the order they opened (``Span``)."""
    return [Span(*r) for r in _records]


def reset() -> list:
    """Clear the recorded spans and the marker ring; returns the spans.
    Counters are left as they are: read them as differences."""
    out = spans()
    _records.clear()
    _open.clear()
    if _LIB:
        _check(_LIB["lib"].trace_reset(), "trace_reset")
    return out


def count(name: str, n=1):
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str):
    return _counters.get(name, 0)


def counters() -> dict:
    return dict(_counters)


def since(before: dict, after: Optional[dict] = None) -> dict:
    """The counters that changed from the snapshot ``before`` to ``after``
    (default: now), by how much."""
    after = _counters if after is None else after
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


# -- phase markers -------------------------------------------------------------

_LIB: dict = {}


def _check(err: int, call: str):
    if err != 0:
        raise RuntimeError(f"{call} failed: cudaError_t {err}")


def _trace_lib():
    """The kernels' library with the marker functions bound (once)."""
    if not _LIB:
        from icem_torch.ops._build import load_library

        lib = load_library()[0]
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.trace_mark.argtypes = [i32, vp, ctypes.POINTER(vp)]
        lib.trace_set_markers.argtypes = [vp, ctypes.POINTER(vp), i32, i32]
        lib.trace_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
        lib.trace_reset.argtypes = []
        lib.trace_ring_capacity.argtypes = []
        for fn in (lib.trace_mark, lib.trace_set_markers, lib.trace_read, lib.trace_reset):
            fn.restype = i32
        lib.trace_ring_capacity.restype = ctypes.c_longlong
        _LIB["lib"] = lib
    return _LIB["lib"]


@contextlib.contextmanager
def capturing():
    """Markers launched in this block go into the graph being captured;
    yields the list that collects their nodes."""
    nodes, prev = [], getattr(_state, "capture", None)
    _state.capture = nodes
    try:
        yield nodes
    finally:
        _state.capture = prev


def _mark(phase_id: int, device):
    cap = getattr(_state, "capture", None)
    if device.type != "cuda" or (cap is None and not active()):
        return
    lib = _trace_lib()
    node = ctypes.c_void_p()
    _check(lib.trace_mark(phase_id, torch.cuda.current_stream(device).cuda_stream,
                          ctypes.byref(node)), "trace_mark")
    if cap is not None:
        if not node.value:
            raise RuntimeError("a phase marker launched in a capture made no graph node")
        cap.append(node.value)


def mark_step(device):
    """The marker that opens a control step."""
    _mark(0, device)


class _Phase:
    __slots__ = ("_span", "_id", "_device")

    def __init__(self, name: str, device):
        self._span, self._id, self._device = span(name), _PHASE_ID[name], device

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            _mark(self._id, self._device)
        return self._span.__exit__(*exc)


def phase(name: str, device):
    """One phase of the control step (``PHASES``): a host span, and a marker
    at its end on ``device`` while a graph is being captured or tracing is
    active; a shared no-op otherwise."""
    if getattr(_state, "capture", None) is None and not active():
        return _NULL
    return _Phase(name, torch.device(device))


def graph_markers(graph, captured: list):
    """The marker nodes ``captured`` into an instantiated
    ``torch.cuda.CUDAGraph`` (kept with ``keep_graph=True``), disabled;
    None where it has none."""
    if not captured:
        return None
    nodes = (ctypes.c_void_p * len(captured))(*captured)
    set_graph_markers(graph, nodes, False)
    return nodes


def set_graph_markers(graph, nodes, on: bool):
    """Enable or disable a graph's marker nodes (from ``graph_markers``)."""
    _check(_trace_lib().trace_set_markers(graph.raw_cuda_graph_exec(), nodes, len(nodes),
                                          int(on)), "trace_set_markers")


def marker_stamps() -> Optional[list]:
    """The markers' stamps since the last ``reset()``, flat: phase id, ns,
    phase id, ns, ... None where no marker ran in this process, or where the
    ring overflowed (counted as ``trace.ring_overflows``)."""
    if not _LIB:
        return None
    lib = _LIB["lib"]
    torch.cuda.synchronize()
    capacity = lib.trace_ring_capacity()
    head = ctypes.c_ulonglong()
    out = (ctypes.c_longlong * (2 * capacity))()
    _check(lib.trace_read(ctypes.byref(head), out, capacity), "trace_read")
    if head.value > capacity:
        count("trace.ring_overflows")
        return None
    return out[: 2 * head.value]


def device_phases() -> Optional[dict]:
    """Device ms of each phase in each control step marked since the last
    ``reset()`` (``phase_ms``); None where nothing was stamped."""
    stamps = marker_stamps()
    return phase_ms(stamps) if stamps else None


def phase_ms(stamps) -> dict:
    """``{phase: [ms of step 0, ms of step 1, ...]}`` from flat (phase id,
    ns) stamps: a "step" stamp opens a control step, and each other phase
    runs from the stamp before its own; stamps before the first step's
    are left out."""
    per = {name: [] for name in PHASES[1:]}
    prev = None
    for pid, t in zip(stamps[0::2], stamps[1::2]):
        if pid == 0:
            for ms in per.values():
                ms.append(0.0)
        elif per["env.step"]:
            per[PHASES[pid]][-1] += (t - prev) * 1e-6
        prev = t
    return per
