"""icem_torch/tools/compare_icem_cem.py against scripts/compare_icem_cem.py:
the envs and planners it builds at each budget, and the table's layout from
a tiny run of the tool on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import icem_torch.runtime.rollout
import icem_tpu.runtime.rollout
import scripts.compare_icem_cem as jax_compare
from icem_torch.tools import compare_icem_cem as compare

ROOT = Path(__file__).resolve().parents[1]
ENV_FLAGS = ("exclude_current_positions", "penalise_flipping", "shaped_reward",
             "add_bonus_rewards")


def _stub_manager(built):
    """A RolloutManager that records the env, the planner and its params, and
    returns two-step episodes of zeros with rewards 1 and 2."""
    class Manager:
        def __init__(self, env, rollout_params, device=None):
            built.append(dict(env=env, rollout_params=dict(rollout_params)))

        def sample(self, policy, mode="train", no_rollouts=1, **kwargs):
            built[-1].update(policy=policy, mode=mode, no_rollouts=no_rollouts)
            env = built[-1]["env"]
            zeros = lambda d: np.zeros((2, d), np.float32)  # noqa: E731
            return [dict(rewards=np.array([1.0, 2.0], np.float32),
                         observations=zeros(env.obs_dim), actions=zeros(env.action_dim),
                         next_observations=zeros(env.obs_dim)) for _ in range(no_rollouts)]
    return Manager


@pytest.mark.parametrize("kind", ["icem", "cem"])
@pytest.mark.parametrize("budget", [8, 128])
@pytest.mark.parametrize("env_name", ["halfcheetah", "door"])
def test_planners_match_the_jax_script(monkeypatch, env_name, budget, kind):
    built = []
    monkeypatch.setattr(icem_tpu.runtime.rollout, "RolloutManager", _stub_manager(built))
    monkeypatch.setattr(icem_torch.runtime.rollout, "RolloutManager", _stub_manager(built))
    assert compare.PLANNER == jax_compare.PLANNER
    th = compare.PLANNER[env_name]["task_horizon"]
    jax_out = jax_compare.run_planner(kind, env_name, budget, 2, th, seed=5)
    port_out = compare.run_planner(kind, env_name, budget, 2, th, seed=5, device="cpu")
    assert port_out == jax_out
    assert (port_out[1] is None) == (env_name == "halfcheetah")
    jax_run, port_run = built
    assert type(port_run["policy"]).__name__ == type(jax_run["policy"]).__name__
    cfg = dataclasses.asdict(port_run["policy"].cfg)
    assert cfg == dataclasses.asdict(jax_run["policy"].cfg)
    assert cfg["num_simulated_trajectories"] == budget
    assert cfg["elites_size"] == max(2, budget // 4) and cfg["horizon"] == 30
    assert port_run["policy"]._seed == jax_run["policy"]._seed == 5
    for key in ("rollout_params", "mode", "no_rollouts"):
        assert port_run[key] == jax_run[key], key
    assert type(port_run["env"]).__name__ == type(jax_run["env"]).__name__
    for flag in ENV_FLAGS:
        assert getattr(port_run["env"], flag, None) == getattr(jax_run["env"], flag, None), flag


def test_the_tool_on_the_cpu_writes_the_jax_layout(tmp_path):
    out = tmp_path / "compare.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "ENVS": "halfcheetah,door", "BUDGETS": "8",
           "SEEDS": "0", "EPISODES": "1", "TASK_HORIZON": "3"}
    done = subprocess.run([sys.executable, "-m", "icem_torch.tools.compare_icem_cem",
                           "--out", str(out), "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(out.read_text())
    assert json.loads(done.stdout.splitlines()[-1]) == got
    reference = json.loads((ROOT / "results" / "ICEM_VS_CEM_r03.json").read_text())
    assert set(got) == set(reference)
    assert got["metric"] == "icem_vs_cem" and got["episodes_per_seed"] == 1
    assert got["seeds"] == [0] and set(got["envs"]) == {"halfcheetah", "door"}
    for name, table in got["envs"].items():
        assert set(table) == {"task_horizon", "device", "card", "8"}
        assert table["task_horizon"] == 3 and table["device"] == "cpu" and table["card"] is None
        want = next(v for k, v in reference["envs"][name].items() if k != "task_horizon")
        assert set(table["8"]) == set(want)
        assert all(np.isfinite(v) for v in table["8"].values())
    assert {"icem_success", "cem_success"} <= set(got["envs"]["door"]["8"])


def test_the_tool_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare, "compare_row", lambda *a, **k: pytest.fail("a row ran"))
    with pytest.raises(RuntimeError, match="CUDA"):
        compare.main(["--out", str(tmp_path / "compare.json")])
    assert not (tmp_path / "compare.json").exists()
