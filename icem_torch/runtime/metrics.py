"""Metrics / logging / observability.

Counterpart of ``icem_tpu/runtime/metrics.py``: scoped loggers, per-key step
counters, an always-on machine-readable ``metrics.jsonl`` stream, TensorBoard
events where ``torch.utils.tensorboard`` imports, per-phase wall-clock
timers, and a device trace from ``torch.profiler`` (``jax.profiler`` in the
JAX package).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


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
    def phase_timer(self, name: str, step: Optional[int] = None):
        """Wall-clock a phase and log it as ``<name>_time``."""
        t0 = time.perf_counter()
        yield
        self.log(time.perf_counter() - t0, key=f"{name}_time", step=step)

    @contextlib.contextmanager
    def device_trace(self, trace_dir: Optional[str] = None):
        """Trace a block with torch.profiler, the card too where there is one,
        into ``<trace_dir>/trace.json`` (Chrome trace format)."""
        from torch.profiler import ProfilerActivity, profile
        import torch

        out = trace_dir or os.path.join(self.logdir, "traces")
        os.makedirs(out, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
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
