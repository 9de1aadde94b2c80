"""Run one cell of the benchmark of ``icem_torch`` on the card this process
finds, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch of the window. The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the result's last key. The run exits
non-zero, printing no result, without a CUDA card, without the program, or
where a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    harness.apply_cache_environment()
    import torch

    bench = harness.manifest()
    cell = harness.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"[card] {harness.card()}", file=sys.stderr, flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"), start=START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr, flush=True)
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
