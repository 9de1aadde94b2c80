"""The compiled steps' calls in a control step of the host loop: the sum
of the ``graphs.replay:<name>`` spans (copy-in, the graph's launch, the
output copies) inside each traced ``rollout.step`` span, median in ms, from
the program's spans (``icem_torch.runtime.metrics.spans``). None where the
program records no such span."""

from benchmark.harness import median
from icem_torch.runtime import metrics


def read(run):
    spans = getattr(metrics, "spans", None)
    if spans is None or run.path != "host":
        return None
    records = spans()
    steps = {i: 0 for i, r in enumerate(records)
             if r.name == "rollout.step" and r.parent is None and r.end_ns is not None}
    for r in records:
        if r.step in steps and r.name.startswith("graphs.replay:") and r.end_ns is not None:
            steps[r.step] += r.end_ns - r.start_ns
    return median(steps.values()) * 1e-6 if steps else None
