"""icem_torch/tools/cem_door_sanity.py against scripts/cem_door_sanity.py:
the env, planner and episode it runs, the block it writes from a tiny run
on the CPU, and its assertions."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import icem_torch.runtime.rollout
import icem_tpu.runtime.rollout
import scripts.cem_door_sanity as jax_sanity
from icem_torch.tools import cem_door_sanity as sanity

# the keys of the JAX script's cem_flatline_check block
JAX_KEYS = {"budget", "seeds", "task_horizon", "prediction_matches",
            "seeds_differ_rms_action_distance", "within_episode_action_std",
            "max_door_angle_any_seed", "returns_unrounded", "returns_std_unrounded",
            "constant_cost_prediction", "notes"}


def _stub_manager(built):
    """A RolloutManager that records the env, the planner and its params, and
    returns one two-step episode with seeded actions and a shut door."""
    class Manager:
        def __init__(self, env, rollout_params, device=None):
            built.append(dict(env=env, rollout_params=dict(rollout_params)))

        def sample(self, policy, mode="train", no_rollouts=1, **kwargs):
            built[-1].update(policy=policy, mode=mode, no_rollouts=no_rollouts)
            env = built[-1]["env"]
            acts = np.random.default_rng(policy._seed).uniform(-1, 1, (2, env.action_dim))
            return [dict(rewards=np.array([-0.25, -0.5], np.float32),
                         actions=acts.astype(np.float32),
                         next_observations=np.zeros((2, env.obs_dim), np.float32))
                    for _ in range(no_rollouts)]
    return Manager


@pytest.mark.parametrize("budget,seed", [(8, 0), (64, 3)])
def test_the_episode_is_the_jax_scripts(monkeypatch, budget, seed):
    built = []
    monkeypatch.setattr(icem_tpu.runtime.rollout, "RolloutManager", _stub_manager(built))
    monkeypatch.setattr(icem_torch.runtime.rollout, "RolloutManager", _stub_manager(built))
    want = jax_sanity.run_cem_door(budget, seed, 7)
    got = sanity.run_cem_door(budget, seed, 7, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got.pop("actions"), want.pop("actions"))
    assert got == want
    jax_run, port_run = built
    assert type(port_run["policy"]).__name__ == type(jax_run["policy"]).__name__ == "MpcCemStd"
    cfg = dataclasses.asdict(port_run["policy"].cfg)
    assert cfg == dataclasses.asdict(jax_run["policy"].cfg)
    assert cfg["num_simulated_trajectories"] == budget and cfg["horizon"] == 30
    assert port_run["policy"]._seed == jax_run["policy"]._seed == seed
    for key in ("rollout_params", "mode", "no_rollouts"):
        assert port_run[key] == jax_run[key], key
    assert port_run["env"].shaped_reward is jax_run["env"].shaped_reward is False


def test_the_tool_on_the_cpu_writes_the_block(monkeypatch, tmp_path):
    out = tmp_path / "compare.json"
    out.write_text(json.dumps({"metric": "icem_vs_cem", "envs": {"door": {"8": {}}}}))
    monkeypatch.setenv("SEEDS", "0,1")
    monkeypatch.setenv("BUDGET", "8")
    monkeypatch.setenv("TASK_HORIZON", "10")
    assert sanity.main(["--out", str(out), "--device", "cpu"]) == 0
    data = json.loads(out.read_text())
    assert data["metric"] == "icem_vs_cem" and data["envs"] == {"door": {"8": {}}}
    block = data["cem_flatline_check"]
    assert set(block) == JAX_KEYS | {"device", "card"}
    assert block["device"] == "cpu" and block["card"] is None
    assert block["budget"] == 8 and block["seeds"] == [0, 1] and block["task_horizon"] == 10
    # the flatline: different live actions, a shut door, the constant cost
    assert block["seeds_differ_rms_action_distance"] > 0.05
    assert block["within_episode_action_std"] > 0.05
    assert block["max_door_angle_any_seed"] < 0.2
    assert block["returns_std_unrounded"] < 0.05 and block["prediction_matches"] is True
    assert block["constant_cost_prediction"] == round(-0.1 * 1.57 ** 2 * 10, 3)
    np.testing.assert_allclose(block["returns_unrounded"], -0.1 * 1.57 ** 2 * 10, atol=0.05)


def _fake_episodes(monkeypatch, **per_seed):
    def run(budget, seed, task_horizon, device=None):
        ep = {"return": -0.1 * 1.57 ** 2 * task_horizon, "max_door_angle": 0.0,
              "actions": np.random.default_rng(seed).uniform(-1, 1, (task_horizon, 28))}
        ep.update({k: v[seed] if isinstance(v, dict) else v for k, v in per_seed.items()})
        ep["action_std_within_episode"] = float(np.std(ep["actions"]))
        return ep
    monkeypatch.setattr(sanity, "run_cem_door", run)


@pytest.mark.parametrize("fault,match", [
    (dict(actions=np.zeros((10, 28))), "near-identical|frozen mean"),
    (dict(max_door_angle={0: 0.05, 1: 0.4}), "door moved"),
    (dict(**{"return": {0: -2.0, 1: -3.0}}), "rounding band"),
    (dict(**{"return": -3.5}), "constant cost"),
])
def test_each_assertion_trips(monkeypatch, fault, match):
    _fake_episodes(monkeypatch, **fault)
    with pytest.raises(AssertionError, match=match):
        sanity.flatline_check(8, [0, 1], 10, device="cpu")


def test_the_tool_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sanity, "flatline_check", lambda *a, **k: pytest.fail("a seed ran"))
    with pytest.raises(RuntimeError, match="CUDA"):
        sanity.main(["--out", str(tmp_path / "compare.json")])
    assert not (tmp_path / "compare.json").exists()
