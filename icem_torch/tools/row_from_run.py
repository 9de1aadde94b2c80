"""Fold finished runs of the driver into the port's quality table, the
counterpart of ``scripts/row_from_run.py``.

    python -m icem_torch.tools.row_from_run <run_dir> [<run_dir> ...] <config> \\
        --out table.json [--device cuda|cpu]

A run of ``python -m icem_torch.main <settings> model_dir=<run_dir>`` that
already exists on disk is the same evidence as a seed of
``icem_torch/tools/quality_table.py`` at no extra card time. The row is
computed from the run directory's ``settings.json`` and ``metrics.jsonl``
with the JAX script's keys and formulas, and merged into ``--out`` (the
table file of ``quality_table.py``; rows already there are kept, the
config's own is replaced). One directory gives a one-seed row naming its
``source_run``; several (e.g. the seed directories of
``quality_table.py --runs``) are aggregated with ``quality_table.aggregate``
into one mean +/- std row, ``seeds`` and ``source_run`` set as the JAX script
sets them.

Departures from the JAX script, each deliberate:

(a) The row goes to ``--out`` only, never under ``results/``.
(b) Every row has ``device`` and ``card``, as the table's rows do. A run
    directory does not record where it ran, so ``device`` is what
    ``--device`` says, and with ``--device cuda`` ``card`` is this machine's
    card as ``nvidia-smi`` names it: fold a run on the machine it ran on.
    Without ``--device`` both are null. (The JAX script reads
    ``ICEM_ROW_DEVICE``.)
(c) ``wall_s`` is, as in the JAX script, the sum of the iterations' times; a
    table row's ``wall_s`` is the whole run's wall clock.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from icem_torch.tools.quality_table import REPO, aggregate


def row_from_run(run_dir: str, device: str | None = None, card: str | None = None) -> dict:
    """One run directory's table row (the keys of
    ``scripts/row_from_run.py::row_from_run``, with ``device`` and ``card``)."""
    with open(os.path.join(run_dir, "settings.json")) as f:
        params = json.load(f)
    info: dict = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            info.setdefault(rec["key"], []).append(rec["value"])

    th = params.get("rollout_params", {}).get("task_horizon", 200)
    n_roll = params.get("number_of_rollouts", 1)
    exec_times = info.get("train_exec_time", [])
    steady = exec_times[1:] if len(exec_times) > 1 else exec_times
    steps_per_s = (n_roll * th / (sum(steady) / len(steady))) if steady else None
    row = {
        "env": params["env"],
        "controller": params["controller"],
        "forward_model": params["forward_model"],
        "task_horizon": th,
        "iterations_run": len(info.get("train_mean_return", [])),
        "final_mean_return": round(float(info["train_mean_return"][-1]), 2),
        "best_mean_return": round(float(max(info["train_mean_return"])), 2),
        "wall_s": round(float(sum(exec_times)), 1),
        "compile_s": round(float(exec_times[0]), 1) if exec_times else None,
        "env_steps_per_s": round(steps_per_s, 1) if steps_per_s else None,
        "seeds": 1,
        "source_run": os.path.relpath(run_dir, REPO),
        "device": device,
        "card": card,
    }
    if "train_mean_success" in info:
        row["final_mean_success"] = round(float(info["train_mean_success"][-1]), 3)
    if "required_iterations_to_solve" in info:
        solve_at = int(info["required_iterations_to_solve"][-1])
        row["solved"] = bool(solve_at < int(params["training_iterations"]))
        row["solved_at_iteration"] = solve_at
    return row


def fold(run_dirs, device: str | None = None, card: str | None = None) -> dict:
    """The row of one run directory, or several aggregated as the table does."""
    rows = [row_from_run(d, device, card) for d in run_dirs]
    if len(rows) == 1:
        return rows[0]
    row = aggregate(rows)
    row["seeds"] = len(rows)
    row["source_run"] = [r["source_run"] for r in rows]
    return row


def merge_row(out_path: str, name: str, row: dict):
    """Put ``row`` under ``configs[name]`` of the table file, keeping the rest."""
    table = {"metric": "per_config_control_quality", "configs": {}}
    if os.path.exists(out_path):
        with open(out_path) as f:
            table = json.load(f)
    table.setdefault("configs", {})[name] = row
    with open(out_path, "w") as f:
        json.dump(table, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m icem_torch.tools.row_from_run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dirs", nargs="+", metavar="RUN_DIR")
    ap.add_argument("config", help="the row's name, e.g. ant/i-cem-blitz")
    ap.add_argument("--out", required=True, help="the table's JSON file; other rows are kept")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the runs executed (a run directory does not record it)")
    args = ap.parse_args(argv)
    card = None
    if args.device == "cuda":
        import torch

        from icem_torch.tools.quality_table import card_name

        card = card_name(torch.device("cuda"))
    row = fold(args.run_dirs, args.device, card)
    merge_row(args.out, args.config, row)
    print(json.dumps({args.config: row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
