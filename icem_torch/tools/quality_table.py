"""Per-config control-quality table of the port, the counterpart of
``scripts/quality_table.py``.

    python -m icem_torch.tools.quality_table --out table.json [--device cpu] [--eager] \\
        [--runs DIR]
    CONFIGS=pendulum/i-cem-blitz ICEM_QUALITY_SEEDS=0,1 \\
        python -m icem_torch.tools.quality_table --out table.json

Runs every shipped ``settings/*/*.json`` experiment (``defaults`` left out:
19 configs) through the driver, ``icem_torch.main.run``, over
``ICEM_QUALITY_SEEDS`` (default ``0,1,2``), one seed per fresh interpreter,
and records per config the mean and std over the seeds of the final and best
return, the success rate and the solve metric where the config defines them,
and the episodes' throughput. The switches are the JAX script's, under its
names: ``CONFIGS`` (comma-separated substrings of the settings paths),
``ICEM_QUALITY_SEEDS``, ``ICEM_QUALITY_FULL`` (learned-model configs train
for their full iteration count instead of ``TRUNCATE_ITERS``),
``ICEM_QUALITY_TH`` (every episode cut to this many steps, recorded in the
row) and ``ICEM_QUALITY_NO_FUSE`` (host-driven episodes). The overrides each
run gets, the row and the aggregate are the JAX script's one for one
(``tests/test_torch_quality_table.py`` holds them against it), so the rows
line up key for key with ``results/QUALITY_r05.json``.

The table goes to ``--out`` after every seed; rows already in that file are
kept, and a config run again replaces its row. Each seed's ``model_dir`` is
a temporary directory, removed after the seed: nothing else is written.
With ``--runs DIR`` it is ``DIR/<config>_s<seed>`` instead, and is kept, so
``icem_torch/tools/row_from_run.py`` can fold it later.

Departures from the JAX script, each deliberate:

(a) No "retry unfused" after a failed seed. The JAX script retries because a
    TPU worker crash poisons the backend of its process; here a retry would
    be a fallback that hides a fault. A seed whose process exits non-zero
    becomes an ``error`` row holding its exit code and the last lines of its
    stderr, and the table goes on.
(b) ``ICEM_QUALITY_NO_FUSE`` is only a switch the user sets; it marks the row
    ``unfused_episodes``.
(c) ``device`` is ``"cuda"`` or ``"cpu"``.
(d) Every row has ``card``: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (null on the CPU), so a throughput is never read without its card.
(e) ``--eager`` rows carry ``"graphs": false``: their steps ran without CUDA
    graphs. (The CPU never captures a graph.)
(f) ``compile_s`` keeps its key so that rows line up with the JAX table. Here
    it is iteration 0's time, which holds the kernels' build where it is not
    cached yet and the CUDA graph captures; the steady rate,
    ``env_steps_per_s``, comes from the later iterations.

Each seed's interpreter also prints its B1 / B2 launches and rows and its
unrounded per-iteration returns (``QUALITY_RUN``); ``run_seed`` returns them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SETTINGS_DIR = os.path.join(REPO, "settings")

# learned-model configs train for many iterations; cap them for the table
# (the JAX script's caps and its reasons, scripts/quality_table.py:35-47)
TRUNCATE_ITERS = {
    "halfcheetah_running/ensemble-icem": 10,
    "pendulum/ensemble-icem": 5,
    "planet/cartpole_swingup": 20,
    "planet/cheetah_run": 8,
    "planet/reacher_easy": 8,
}

GROUND_TRUTH = ("GroundTruthModel", "ParallelGroundTruthModel")
ROW_MARK = "QUALITY_ROW "
RUN_MARK = "QUALITY_RUN "
STDERR_TAIL_LINES = 30


def config_names(only: str | None = None) -> list:
    """The shipped configs, ``settings/<dir>/<name>`` without ``defaults``,
    sorted; ``only``: comma-separated substrings of the path, as CONFIGS."""
    paths = sorted(glob.glob(os.path.join(SETTINGS_DIR, "*", "*.json")))
    paths = [p for p in paths if "/defaults/" not in p and not p.endswith("/defaults.json")]
    if only:
        keys = only.split(",")
        paths = [p for p in paths if any(k in p for k in keys)]
    return [os.path.relpath(p, SETTINGS_DIR)[:-len(".json")] for p in paths]


def card_name(device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def run_config(path: str, out_root: str, seed: int, device=None, eager: bool = False):
    """One seed of one config through ``icem_torch.main.run``: (name, row,
    the run's reward dict)."""
    from icem_torch import main as driver
    from icem_torch.device import resolve_device
    from icem_torch.runtime.config import resolve_settings

    device = resolve_device(device)
    name = os.path.relpath(path, SETTINGS_DIR)[:-len(".json")]
    params = resolve_settings(path)
    over = {"model_dir": os.path.join(out_root, f"{name.replace('/', '_')}_s{seed}"),
            "seed": seed,
            "checkpoints": {"load": False, "save": False}}
    is_gt = params.forward_model in GROUND_TRUTH
    if is_gt:
        # no training loop, so episodes are independent: >= 3 per iteration
        over["number_of_rollouts"] = max(3, int(params.get("number_of_rollouts", 1)))
    rp_over = {}
    if os.environ.get("ICEM_QUALITY_NO_FUSE"):
        rp_over["fuse_on_device"] = False
    if os.environ.get("ICEM_QUALITY_TH"):
        rp_over["task_horizon"] = int(os.environ["ICEM_QUALITY_TH"])
    if rp_over:
        over["rollout_params"] = {**params.rollout_params.get_pickleable(), **rp_over}
    truncated = None
    if name in TRUNCATE_ITERS and not os.environ.get("ICEM_QUALITY_FULL"):
        truncated = TRUNCATE_ITERS[name]
        over["training_iterations"] = truncated
    elif is_gt and int(params.training_iterations) < 3:
        # >= 3 iterations x >= 3 rollouts: 9+ episodes a seed, and a steady
        # rate from the iterations after the first
        over["training_iterations"] = 3
    elif int(params.training_iterations) < 2:
        # at least two iterations, so the steady rate excludes iteration 0
        over["training_iterations"] = 2
    params = resolve_settings({**params.get_pickleable(), **over})

    t0 = time.time()
    info = driver.run(params, device=device, eager=eager)
    wall = time.time() - t0

    th = params.rollout_params.get("task_horizon", 200)
    n_roll = params.get("number_of_rollouts", 1)
    iters = len(info.get("step", []))
    # iteration 0 holds the build and the graph captures: the steady rate
    # comes from the later iterations where there are any
    exec_times = info.get("train_exec_time", [])
    steady = exec_times[1:] if len(exec_times) > 1 else exec_times
    steps_per_s = (n_roll * th / (sum(steady) / len(steady))) if steady else None
    row = {
        "env": params.env,
        "controller": params.controller,
        "forward_model": params.forward_model,
        "device": device.type,
        "card": card_name(device),
        "task_horizon": th,
        "iterations_run": iters,
        "final_mean_return": round(float(info["train_mean_return"][-1]), 2),
        "best_mean_return": round(float(max(info["train_mean_return"])), 2),
        "wall_s": round(wall, 1),
        "compile_s": round(float(exec_times[0]), 1) if exec_times else None,
        "env_steps_per_s": round(steps_per_s, 1) if steps_per_s else None,
    }
    if eager:
        row["graphs"] = False
    if truncated is not None:
        row["truncated_to_iters"] = truncated
    if not is_gt:
        # learned models: the whole learning curve, not just its endpoints
        row["return_curve"] = [round(float(r), 1) for r in info["train_mean_return"]]
    if os.environ.get("ICEM_QUALITY_TH"):
        row["truncated_task_horizon"] = int(os.environ["ICEM_QUALITY_TH"])
    if os.environ.get("ICEM_QUALITY_NO_FUSE"):
        row["unfused_episodes"] = True
    if "train_mean_success" in info:
        row["final_mean_success"] = round(float(info["train_mean_success"][-1]), 3)
    if "required_iterations_to_solve" in info:
        solve_at = int(info["required_iterations_to_solve"][-1])
        row["solved"] = bool(solve_at < params.training_iterations)
        row["solved_at_iteration"] = solve_at
    return name, row, info


def aggregate(rows):
    """Seed-aggregated row: mean +/- std of the per-seed statistics."""
    agg = dict(rows[0])            # env/controller/model/horizon metadata
    agg["seeds"] = len(rows)

    def stat(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        if not vals:
            return None, None
        return (round(float(np.mean(vals)), 2),
                round(float(np.std(vals)), 2))

    for key in ("final_mean_return", "best_mean_return", "final_mean_success"):
        if key in agg:
            agg[key], agg[key + "_std"] = stat(key)
    for key in ("wall_s", "compile_s", "env_steps_per_s"):
        if agg.get(key) is not None:
            agg[key] = stat(key)[0]
    if "solved" in agg:
        agg["solved"] = all(bool(r.get("solved")) for r in rows)
        agg["solved_seeds"] = sum(bool(r.get("solved")) for r in rows)
        agg["solved_at_iteration"] = [r.get("solved_at_iteration") for r in rows]
    agg["per_seed_final_return"] = [r.get("final_mean_return") for r in rows]
    curves = [r.get("return_curve") for r in rows if r.get("return_curve")]
    if curves:
        agg["per_seed_return_curve"] = curves
    return agg


def seed_entry(name: str, seed: int, device=None, eager: bool = False, runs=None):
    """The body of one seed's interpreter: run it under a temporary
    directory (or under ``runs``, kept) and print the row and the run's
    launches, rows and returns."""
    from icem_torch.runtime import metrics

    before = metrics.counters()
    path = os.path.join(SETTINGS_DIR, name + ".json")
    if runs is not None:
        _, row, info = run_config(path, runs, seed, device=device, eager=eager)
    else:
        with tempfile.TemporaryDirectory() as out_root:
            _, row, info = run_config(path, out_root, seed, device=device, eager=eager)
    grown = metrics.since(before)
    run = {"launches": {"planar": grown.get("b1.launches", 0),
                        "spatial": grown.get("b2.launches", 0)},
           "rows": {"planar": grown.get("b1.rows", 0), "spatial": grown.get("b2.rows", 0)},
           "train_mean_return": [float(r) for r in info["train_mean_return"]]}
    print(ROW_MARK + json.dumps(row), flush=True)
    print(RUN_MARK + json.dumps(run), flush=True)


def run_seed(name: str, seed: int, device=None, eager: bool = False, env=None, runs=None):
    """Run one (config, seed) in a fresh interpreter: (row, run).

    ``env``: the child's environment (default this process's), which
    carries the switches. The child gets ``--device``, ``--eager`` and
    ``--runs`` as given; asked for the CPU it sees no card. A child that
    exits non-zero gives an error row (its exit code and the tail of its
    stderr) and ``run`` None."""
    cmd = [sys.executable, "-m", "icem_torch.tools.quality_table", "--seed-entry", name,
           str(seed)]
    child_env = dict(os.environ if env is None else env)
    if device is not None:
        cmd += ["--device", str(device)]
        if str(device) == "cpu":
            child_env["CUDA_VISIBLE_DEVICES"] = ""
    if eager:
        cmd.append("--eager")
    if runs is not None:
        cmd += ["--runs", str(runs)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=child_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate()
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    row = run = None
    for line in out.splitlines():
        if line.startswith(ROW_MARK):
            row = json.loads(line[len(ROW_MARK):])
        elif line.startswith(RUN_MARK):
            run = json.loads(line[len(RUN_MARK):])
    if proc.returncode != 0 or row is None or run is None:
        return {"error": f"seed subprocess rc={proc.returncode}", "seed": seed,
                "stderr_tail": err.splitlines()[-STDERR_TAIL_LINES:]}, None
    return row, run


def save_config_rows(table, name, rows, seeds, out_path):
    """Write the config's row from the seeds done so far: after every seed,
    so a campaign cut short keeps every finished seed."""
    ok_rows = [r for r in rows if "error" not in r]
    err_rows = [r for r in rows if "error" in r]
    if ok_rows:
        table[name] = aggregate(ok_rows)
        if err_rows:
            table[name]["errors"] = err_rows
    else:
        table[name] = err_rows[0]
    with open(out_path, "w") as f:
        json.dump({"metric": "per_config_control_quality",
                   "seeds": seeds, "configs": table}, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m icem_torch.tools.quality_table",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="the table's JSON file; rows already there are kept")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default: the CUDA device")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly instead of replaying CUDA graphs")
    ap.add_argument("--runs", default=None,
                    help="keep each seed's model_dir as RUNS/<config>_s<seed> "
                         "(default: a temporary directory, removed)")
    ap.add_argument("--seed-entry", nargs=2, metavar=("CONFIG", "SEED"),
                    help=argparse.SUPPRESS)  # one seed's interpreter (run_seed)
    args = ap.parse_args(argv)
    if args.seed_entry:
        seed_entry(args.seed_entry[0], int(args.seed_entry[1]), args.device, args.eager,
                   args.runs)
        return 0
    if not args.out:
        ap.error("--out is required")

    from icem_torch.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise before any seed runs
    seeds = [int(s) for s in os.environ.get("ICEM_QUALITY_SEEDS", "0,1,2").split(",")]
    table = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            table = json.load(f).get("configs", {})
    for name in config_names(os.environ.get("CONFIGS")):
        rows = []
        for seed in seeds:
            print(f"=== {name} seed {seed}", file=sys.stderr, flush=True)
            row, run = run_seed(name, seed, args.device, args.eager, runs=args.runs)
            if run is None:
                print(f"=== {name} seed {seed}: {row['error']}\n"
                      + "\n".join(row["stderr_tail"]), file=sys.stderr, flush=True)
            else:
                print(f"=== {name} seed {seed}: launches {run['launches']}",
                      file=sys.stderr, flush=True)
            rows.append(row)
            save_config_rows(table, name, rows, seeds, args.out)
        print(json.dumps({name: table[name]}), file=sys.stderr, flush=True)
    print(json.dumps({"metric": "per_config_control_quality", "configs": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
