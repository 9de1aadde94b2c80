"""Run one cell on several seeds in one process and write, for each seed,
every number the check compares for the program and for the control (the
reference computed in bfloat16 in the program's place), with the run's
metrics and set-up. The readings behind ``benchmark/limits/<cell>.json``.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 32 --out calibrate.json [--trace 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3,
                        help="compute the control's numbers on the first this many seeds")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from benchmark import harness

    harness.apply_cache_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = harness.card() if args.device == "cuda" else "cpu"
    out_path = Path(args.out)
    rows = json.loads(out_path.read_text()) if out_path.exists() else []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                             torch.device(args.device), control=i < args.control_seeds,
                             log=lambda m: print(m, file=sys.stderr, flush=True))
        row = {"workload": args.workload, "seed": seed, "card": card, "trace": args.trace,
               "seconds": args.seconds, "wall_s": time.perf_counter() - t0,
               "correct": r["correct"], "numbers": r["_numbers"], "control": r.get("_control"),
               "metrics": r["metrics"], "device": r["device"], "setup": r["_setup"],
               "breakdown": r.get("breakdown")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rows, indent=1))
    print(f"forbidden modules: {harness.forbidden_modules()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
