"""icem_torch/tools/quality_table.py against scripts/quality_table.py: the
overrides each run gets, the row, the aggregate, the table file, and the
tool end to end on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import icem_torch.main
import icem_tpu.main
import scripts.quality_table as jax_table
from icem_torch.tools import quality_table as table

ROOT = Path(__file__).resolve().parents[1]
SWITCHES = ("CONFIGS", "ICEM_QUALITY_SEEDS", "ICEM_QUALITY_FULL", "ICEM_QUALITY_TH",
            "ICEM_QUALITY_NO_FUSE")
# the envs whose episodes report success (the driver's train_mean_success)
SUCCESS_ENVS = ("FetchReach", "FetchPickAndPlace", "Door", "Relocate")
# row keys that name the run's process rather than its outcome
PER_PROCESS = ("device", "card", "wall_s")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _fake_run(calls):
    """A driver that records the params it gets and returns a fixed reward
    dict, with the success and solve keys where the setting defines them."""
    def run(params, *args, **kwargs):
        calls.append(params)
        info = {"step": [0, 1, 2, 3],
                "train_mean_return": [-1.5, 2.25, 10.125, 7.0],
                "train_exec_time": [3.0, 1.0, 1.5, 1.25]}
        if params.env in SUCCESS_ENVS:
            info["train_mean_success"] = [0.0, 0.5, 1 / 3, 1.0]
        if "avg_return_required_to_solve" in params:
            info["required_iterations_to_solve"] = [3, 3, 2, 1]
        return info
    return run


def _both_run_config(monkeypatch, name, tmp_path):
    calls = []
    monkeypatch.setattr(icem_tpu.main, "run", _fake_run(calls))
    monkeypatch.setattr(icem_torch.main, "run", _fake_run(calls))
    path = str(ROOT / "settings" / f"{name}.json")
    jax_name, jax_row = jax_table.run_config(path, str(tmp_path), 4)
    port_name, port_row, _ = table.run_config(path, str(tmp_path), 4, device="cpu")
    assert port_name == jax_name == name
    return calls, jax_row, port_row


def test_config_list_is_the_jax_scripts():
    names = table.config_names()
    assert len(names) == 20
    assert "pendulum/i-cem-blitz" in names and not any("defaults" in n for n in names)
    assert table.config_names("door,fpp") == ["door/i-cem-blitz", "fpp/i-cem-blitz"]
    assert table.TRUNCATE_ITERS == jax_table.TRUNCATE_ITERS


def _cases():
    shipped = [pytest.param(name, None, id=name) for name in table.config_names()]
    # each switch held on a ground-truth and a learned-model config
    switched = [pytest.param(name, (var, value), id=f"{name}-{var}={value}")
                for var, value in (("ICEM_QUALITY_FULL", "1"), ("ICEM_QUALITY_TH", "7"),
                                   ("ICEM_QUALITY_NO_FUSE", "1"))
                for name in ("halfcheetah_running/i-cem-blitz", "planet/cheetah_run")]
    return shipped + switched


@pytest.mark.parametrize("name,switch", _cases())
def test_overrides_and_row_match_the_jax_script(monkeypatch, tmp_path, name, switch):
    if switch is not None:
        monkeypatch.setenv(*switch)
    calls, jax_row, port_row = _both_run_config(monkeypatch, name, tmp_path)
    jax_params, port_params = calls
    for key in ("training_iterations", "number_of_rollouts", "seed", "model_dir"):
        assert port_params.get(key) == jax_params.get(key), key
    for key in ("checkpoints", "rollout_params"):
        assert port_params[key].get_pickleable() == jax_params[key].get_pickleable(), key
    assert port_row["device"] == "cpu" and port_row["card"] is None
    strip = lambda row: {k: v for k, v in row.items() if k not in PER_PROCESS}  # noqa: E731
    assert strip(port_row) == strip(jax_row)
    assert set(jax_row) | {"card"} == set(port_row)
    success = jax_params.env in SUCCESS_ENVS
    assert ("final_mean_success" in port_row) == success


def test_eager_rows_say_so(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(icem_torch.main, "run", _fake_run(calls))
    path = str(ROOT / "settings" / "pendulum" / "i-cem-blitz.json")
    _, row, _ = table.run_config(path, str(tmp_path), 0, device="cpu", eager=True)
    assert row["graphs"] is False


ROWS = [
    {"env": "ContinuousPendulum", "device": "cpu", "final_mean_return": -150.25,
     "best_mean_return": -90.5, "wall_s": 20.0, "compile_s": 5.0, "env_steps_per_s": 1400.0,
     "final_mean_success": 0.5, "solved": True, "solved_at_iteration": 0,
     "return_curve": [-300.0, -150.2]},
    {"env": "ContinuousPendulum", "device": "cpu", "final_mean_return": -210.0,
     "best_mean_return": -100.0, "wall_s": 22.0, "compile_s": None, "env_steps_per_s": 1300.0,
     "final_mean_success": 1.0, "solved": False, "solved_at_iteration": 3,
     "return_curve": [-250.0, -210.0]},
    {"env": "ContinuousPendulum", "device": "cpu", "final_mean_return": -170.0,
     "best_mean_return": -95.0, "wall_s": 21.0, "compile_s": 4.0, "env_steps_per_s": 1350.0,
     "final_mean_success": 0.0, "solved": True, "solved_at_iteration": 1},
]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_aggregate_matches_the_jax_script(n):
    assert table.aggregate(ROWS[:n]) == jax_table.aggregate(ROWS[:n])


@pytest.mark.parametrize("errors", [0, 1, 3], ids=["no_error", "one_error", "all_errors"])
def test_table_file_matches_the_jax_script(tmp_path, errors):
    rows = [{"error": "seed subprocess rc=1", "seed": i} if i < errors else r
            for i, r in enumerate(ROWS)]
    files = []
    for save in (jax_table._save_config_rows, table.save_config_rows):
        out = tmp_path / f"{len(files)}.json"
        save({"other/config": {"seeds": 2}}, "pendulum/i-cem-blitz", rows, [0, 1, 2], out)
        files.append(json.loads(out.read_text()))
    assert files[0] == files[1]


def _tool(tmp_path, env, *args):
    return subprocess.run([sys.executable, "-m", "icem_torch.tools.quality_table", *args],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), **env},
                          capture_output=True, text=True, timeout=300)


def test_the_tool_end_to_end_on_the_cpu(tmp_path):
    results = sorted(os.listdir(ROOT / "results"))
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    out = tmp_path / "table.json"
    env = {"CONFIGS": "pendulum/i-cem-blitz", "ICEM_QUALITY_SEEDS": "0,1",
           "ICEM_QUALITY_TH": "5", "TMPDIR": str(tmpdir)}
    done = _tool(tmp_path, env, "--out", str(out), "--device", "cpu")
    assert done.returncode == 0, done.stderr[-3000:]
    configs = json.loads(out.read_text())["configs"]
    assert list(configs) == ["pendulum/i-cem-blitz"]
    row = configs["pendulum/i-cem-blitz"]
    assert row["seeds"] == 2 and row["device"] == "cpu" and row["card"] is None
    assert row["truncated_task_horizon"] == 5 and row["iterations_run"] == 3
    assert len(row["per_seed_final_return"]) == 2 and "errors" not in row
    reference = json.loads((ROOT / "results" / "QUALITY_r05.json").read_text())
    assert set(reference["configs"]["pendulum/i-cem-blitz"]) <= set(row)
    assert json.loads(done.stdout.splitlines()[-1])["configs"] == configs

    # a second call with another config keeps the first row
    env.update(CONFIGS="fetch_reach/i-cem-blitz", ICEM_QUALITY_SEEDS="0")
    done = _tool(tmp_path, env, "--out", str(out), "--device", "cpu")
    assert done.returncode == 0, done.stderr[-3000:]
    configs = json.loads(out.read_text())["configs"]
    assert configs["pendulum/i-cem-blitz"] == row
    assert configs["fetch_reach/i-cem-blitz"]["seeds"] == 1
    assert 0.0 <= configs["fetch_reach/i-cem-blitz"]["final_mean_success"] <= 1.0
    # nothing written but --out: no run directory left, nothing under results/
    assert sorted(os.listdir(ROOT / "results")) == results
    assert list(tmpdir.iterdir()) == []


def test_a_failed_seed_gives_an_error_row(monkeypatch):
    row, run = table.run_seed("pendulum/i-cem-blitz", 3, device="cpu",
                              env={**os.environ, "ICEM_QUALITY_TH": "five"})
    assert run is None
    assert row["error"] == "seed subprocess rc=1" and row["seed"] == 3
    assert any("ValueError" in line for line in row["stderr_tail"])


def test_the_table_goes_on_after_a_failed_seed(monkeypatch, tmp_path):
    def run_seed(name, seed, device=None, eager=False, env=None, runs=None):
        if name == "pendulum/i-cem-blitz" and seed == 0 or name.startswith("mountain_car"):
            return {"error": "seed subprocess rc=-11", "seed": seed, "stderr_tail": []}, None
        return dict(ROWS[seed]), {"launches": {}, "train_mean_return": []}

    monkeypatch.setattr(table, "run_seed", run_seed)
    monkeypatch.setenv("CONFIGS", "pendulum/i-cem-blitz,mountain_car,fetch_reach")
    monkeypatch.setenv("ICEM_QUALITY_SEEDS", "0,1,2")
    out = tmp_path / "table.json"
    assert table.main(["--out", str(out), "--device", "cpu"]) == 0
    configs = json.loads(out.read_text())["configs"]
    assert configs["pendulum/i-cem-blitz"]["seeds"] == 2
    assert configs["pendulum/i-cem-blitz"]["errors"] == [
        {"error": "seed subprocess rc=-11", "seed": 0, "stderr_tail": []}]
    assert configs["mountain_car/i-cem-best"]["error"] == "seed subprocess rc=-11"
    assert configs["fetch_reach/i-cem-blitz"]["seeds"] == 3


def test_the_tool_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(table, "run_seed", lambda *a, **k: pytest.fail("a seed ran"))
    with pytest.raises(RuntimeError, match="CUDA"):
        table.main(["--out", str(tmp_path / "table.json")])
    assert not (tmp_path / "table.json").exists()
