"""icem_torch/tools/row_from_run.py against scripts/row_from_run.py: the row
of one run directory, the aggregate of several, the table file, and the
seed directories the quality table keeps folded back into its own row."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import scripts.row_from_run as jax_rfr
from icem_torch.tools import row_from_run as rfr

ROOT = Path(__file__).resolve().parents[1]
# the keys that say where and how a row was made rather than what the run did
PROVENANCE = ("device", "card", "source_run")


def _strip(row, *more):
    return {k: v for k, v in row.items() if k not in PROVENANCE + more}


def _run_dir(path, seed, success=True, solve=True):
    """A finished run: settings.json and metrics.jsonl as the driver writes them."""
    path.mkdir(parents=True)
    settings = {"env": "Door", "controller": "mpc-icem",
                "forward_model": "ParallelGroundTruthModel", "seed": seed,
                "rollout_params": {"task_horizon": 50}, "number_of_rollouts": 3,
                "training_iterations": 3}
    (path / "settings.json").write_text(json.dumps(settings))
    recs = []
    for it in range(3):
        recs.append({"key": "train_mean_return", "value": -40.125 + 17.3 * it * (seed + 1),
                     "step": it})
        recs.append({"key": "train_exec_time", "value": [9.5, 1.25, 1.5][it] + 0.1 * seed,
                     "step": it})
        if success:
            recs.append({"key": "train_mean_success", "value": it / 3, "step": it})
        if solve:
            recs.append({"key": "required_iterations_to_solve", "value": 2 + seed, "step": it})
    (path / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(path)


@pytest.mark.parametrize("success,solve", [(True, True), (False, False)])
def test_one_run_gives_the_jax_row(tmp_path, monkeypatch, success, solve):
    monkeypatch.delenv("ICEM_ROW_DEVICE", raising=False)
    d = _run_dir(tmp_path / "run", 1, success, solve)
    want = jax_rfr.row_from_run(d)
    got = rfr.row_from_run(d, "cuda", "NVIDIA H100 80GB HBM3, 700.00 W")
    assert _strip(got) == _strip(want)
    assert got["source_run"] == want["source_run"] == os.path.relpath(d, ROOT)
    assert got["device"] == "cuda" and got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert ("final_mean_success" in got) == success and ("solved" in got) == solve
    assert rfr.fold([d]) == {**got, "device": None, "card": None}


def _jax_main(monkeypatch, tmp_path, args):
    """scripts/row_from_run.py's main with its table under tmp_path."""
    (tmp_path / "results").mkdir(exist_ok=True)
    monkeypatch.setattr(jax_rfr, "REPO", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["row_from_run.py", *args])
    monkeypatch.setenv("ICEM_ROUND", "3")
    jax_rfr.main()
    return json.loads((tmp_path / "results" / "QUALITY_r03.json").read_text())


@pytest.mark.parametrize("n", [1, 3])
def test_the_table_file_matches_the_jax_script(tmp_path, monkeypatch, n):
    monkeypatch.delenv("ICEM_ROW_DEVICE", raising=False)
    dirs = [_run_dir(tmp_path / "runs" / f"door_s{s}", s) for s in range(n)]
    other = {"ant/i-cem-blitz": {"seeds": 3, "final_mean_return": 429.2}}
    table = {"metric": "per_config_control_quality", "configs": dict(other)}
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "QUALITY_r03.json").write_text(json.dumps(table))
    out = tmp_path / "table.json"
    out.write_text(json.dumps(table))
    want = _jax_main(monkeypatch, tmp_path, [*dirs, "door/i-cem-blitz"])
    assert rfr.main([*dirs, "door/i-cem-blitz", "--out", str(out), "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert got["configs"]["ant/i-cem-blitz"] == other["ant/i-cem-blitz"]
    g, w = got["configs"]["door/i-cem-blitz"], want["configs"]["door/i-cem-blitz"]
    assert _strip(g) == _strip(w) and g["device"] == "cpu" and g["card"] is None
    assert g["seeds"] == n
    if n > 1:
        assert g["source_run"] == [os.path.relpath(d, ROOT) for d in dirs]
        assert len(g["per_seed_final_return"]) == n and "final_mean_return_std" in g


def test_the_quality_tables_seed_directories_fold_into_its_row(tmp_path, monkeypatch):
    """Three seeds of the quality table on the CPU with their directories
    kept (--runs): both scripts fold them into the row the table wrote, but
    for provenance and wall_s (the table times the whole run, the fold sums
    the iterations)."""
    runs, out = tmp_path / "runs", tmp_path / "table.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CONFIGS": "pendulum/i-cem-blitz",
           "ICEM_QUALITY_SEEDS": "0,1,2", "ICEM_QUALITY_TH": "4"}
    done = subprocess.run([sys.executable, "-m", "icem_torch.tools.quality_table", "--out",
                           str(out), "--device", "cpu", "--runs", str(runs)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    table_row = json.loads(out.read_text())["configs"]["pendulum/i-cem-blitz"]
    dirs = [str(runs / f"pendulum_i-cem-blitz_s{s}") for s in range(3)]
    got = rfr.fold(dirs, "cpu")
    want = _jax_main(monkeypatch, tmp_path, [*dirs, "pendulum/i-cem-blitz"])
    want = want["configs"]["pendulum/i-cem-blitz"]
    assert _strip(got, "wall_s") == _strip(want, "wall_s")
    assert got["seeds"] == table_row["seeds"] == 3
    assert {k: got[k] for k in _strip(got, "wall_s")} == {k: table_row[k]
                                                          for k in _strip(got, "wall_s")}
