"""The host loop's own work a control step: each traced ``rollout.step``
span less the blocking reads inside it (``rollout.readback.*``,
``icem.readback.action``), median in ms, from the program's spans
(``icem_torch.runtime.metrics.spans``). None where the program records no
such span."""

from benchmark.harness import median
from icem_torch.runtime import metrics

READS = ("rollout.readback.", "icem.readback.")


def read(run):
    spans = getattr(metrics, "spans", None)
    if spans is None or run.path != "host":
        return None
    records = spans()
    steps = {i: r.end_ns - r.start_ns for i, r in enumerate(records)
             if r.name == "rollout.step" and r.parent is None and r.end_ns is not None}
    for r in records:
        if r.step in steps and r.name.startswith(READS) and r.end_ns is not None:
            steps[r.step] -= r.end_ns - r.start_ns
    return median(steps.values()) * 1e-6 if steps else None
