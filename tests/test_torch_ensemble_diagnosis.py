"""icem_torch/tools/ensemble_diagnosis.py against scripts/ensemble_diagnosis.py.

Both ``RolloutManager`` classes are stubbed with one seeded numpy dataset,
and both ``EnsembleModel.train`` methods with a step that keeps the JAX
model's seed-0 weights and hands them to the port's model
(``icem_torch.convert.ensemble_params_from_arrays``); training itself is held
by ``tests/test_torch_ensemble.py``. The controllers are built but never run.
The JAX script's ``main`` runs with its module global ``REPO`` at a temporary
directory (a ``settings`` link and an empty ``results/``) and its rounding
turned off, so both sides' numbers are unrounded.

Tolerances: the k-step RMSE and the true velocity scale 1e-5 relative
(float32 products of a few hundred terms over up to 20 model steps); the
imagined return with identical members 1e-4 relative (80 steps summed).
"""

import ast
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import icem_torch.runtime.rollout
import icem_tpu.models.ensemble
import icem_tpu.runtime.rollout
import scripts.ensemble_diagnosis as jax_diag
from icem_torch.convert import ensemble_params_from_arrays
from icem_torch.models.ensemble import EnsembleModel
from icem_torch.runtime.buffer import Rollout
from icem_torch.tools import ensemble_diagnosis as diag
from icem_tpu.runtime.buffer import Rollout as JaxRollout

OBS, ACT, EP_LEN = 18, 6, 80
SIZES = dict(n_random=2, n_expert=3, n_heldout=1, n_plan=1, ks=(1, 3, 10, 20))
# the JAX script's module constants for the sizes
JAX_SIZE_NAMES = {"N_RANDOM": "n_random", "N_EXPERT": "n_expert",
                  "N_HELDOUT_EXPERT": "n_heldout", "N_PLAN_EPISODES": "n_plan", "KS": "ks"}
TOP_KEYS = {"what", "env", "task_horizon", "device", "phases", "reference_points", "verdict"}
PHASE_KEYS = {
    "data": {"random_episodes", "expert_episodes", "expert_returns", "random_returns",
             "wall_s"},
    "train": {"nll", "mse", "num_transitions", "wall_s"},
    "open_loop_rmse": {"heldout_episodes", "starts_per_ep_every", "fwd_vel_obs_index",
                       "true_fwd_vel_rms", "rmse_by_k", "wall_s"},
    "plan_with_learned_model": {"budget", "episodes", "realized_returns", "mean_return",
                                "optimism_gap_per_episode", "wall_s"},
}


def _dataset(call: int, n: int) -> list:
    """``n`` seeded episodes for the ``call``-th sample: a smooth random walk
    of observations, uniform actions, normal rewards."""
    rng = np.random.default_rng(1000 + call)
    eps = []
    for _ in range(n):
        walk = np.cumsum(0.1 * rng.standard_normal((EP_LEN + 1, OBS)), axis=0)
        eps.append(dict(observations=walk[:-1].astype(np.float32),
                        next_observations=walk[1:].astype(np.float32),
                        actions=rng.uniform(-1, 1, (EP_LEN, ACT)).astype(np.float32),
                        rewards=rng.standard_normal(EP_LEN).astype(np.float32),
                        dones=np.zeros(EP_LEN, np.float32)))
    return eps


def _stub_manager(rollout_cls, seen):
    """A RolloutManager whose k-th ``sample`` returns ``_dataset(k, n)``."""
    class Manager:
        def __init__(self, env, rollout_params, device=None):
            self.calls = 0

        def set_epoch(self, epoch):
            pass

        def sample(self, policy, mode="train", name="", no_rollouts=1, **kwargs):
            seen.append((type(policy).__name__, name, no_rollouts))
            self.calls += 1
            return [rollout_cls(data=d) for d in _dataset(self.calls, no_rollouts)]
    return Manager


def _run_both(tmp_path, monkeypatch, same_members: bool):
    """(JAX output, port output, the policies each sampled, the training
    rows each saw)."""
    monkeypatch.setenv("ICEM_NO_COMPILE_CACHE", "1")
    root = tmp_path / "repo"
    (root / "results").mkdir(parents=True)
    os.symlink(os.path.join(jax_diag.REPO, "settings"), root / "settings")
    monkeypatch.setattr(jax_diag, "REPO", str(root))
    monkeypatch.setattr(jax_diag, "round", lambda x, n=None: x, raising=False)
    for name, size in JAX_SIZE_NAMES.items():
        monkeypatch.setattr(jax_diag, name, SIZES[size])
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(icem_tpu.runtime.rollout, "RolloutManager",
                        _stub_manager(JaxRollout, seen["jax"]))
    monkeypatch.setattr(icem_torch.runtime.rollout, "RolloutManager",
                        _stub_manager(Rollout, seen["port"]))
    trained = {}

    def jax_train(self, buffer):
        if same_members:
            self.params = {**self.params, "net": jax.tree_util.tree_map(
                lambda x: jax.numpy.broadcast_to(x[:1], x.shape), self.params["net"])}
        trained["jax"] = (self, np.asarray(buffer.flat["observations"]))
        return {"nll": 1.5, "mse": 2.5, "num_transitions": len(buffer.flat["observations"])}

    def port_train(self, buffer):
        arrays = jax.tree_util.tree_map(np.asarray, trained["jax"][0].params)
        self.net.assign(ensemble_params_from_arrays(arrays, "cpu"))
        trained["port"] = np.asarray(buffer.flat["observations"])
        return {"nll": 1.5, "mse": 2.5, "num_transitions": len(buffer.flat["observations"])}

    monkeypatch.setattr(icem_tpu.models.ensemble.EnsembleModel, "train", jax_train)
    monkeypatch.setattr(EnsembleModel, "train", port_train)

    jax_diag.main()
    with open(root / "results" / "ENSEMBLE_DIAGNOSIS_r05.json") as f:
        want = json.load(f)
    got = diag.diagnose(**SIZES, device="cpu")
    return want, got, seen, (trained["jax"][1], trained["port"])


def test_rmse_matches_the_jax_script_on_the_same_data_and_weights(tmp_path, monkeypatch):
    want, got, seen, rows = _run_both(tmp_path, monkeypatch, same_members=False)
    # the same policies, in the same order, and the same training rows
    assert seen["port"] == seen["jax"] == [("RndController", "diag_rnd", 2),
                                           ("MpcICem", "diag_exp", 3),
                                           ("MpcICem", "diag_plan", 1)]
    np.testing.assert_array_equal(rows[1], rows[0])
    assert set(got) == set(want) == TOP_KEYS
    for phase, keys in PHASE_KEYS.items():
        assert set(got["phases"][phase]) == set(want["phases"][phase]) == keys, phase
    assert got["env"] == want["env"] and got["task_horizon"] == want["task_horizon"] == 1000
    assert got["device"] == "cpu"

    w, g = want["phases"], got["phases"]
    for key in ("random_returns", "expert_returns"):
        np.testing.assert_allclose(g["data"][key], w["data"][key], rtol=1e-6)
    assert g["train"]["num_transitions"] == w["train"]["num_transitions"] == 3 * EP_LEN
    rw, rg = w["open_loop_rmse"], g["open_loop_rmse"]
    for key in ("heldout_episodes", "starts_per_ep_every", "fwd_vel_obs_index"):
        assert rg[key] == rw[key], key
    assert rg["fwd_vel_obs_index"] == 9
    np.testing.assert_allclose(rg["true_fwd_vel_rms"], rw["true_fwd_vel_rms"], rtol=1e-5)
    assert set(rg["rmse_by_k"]) == set(rw["rmse_by_k"]) == {"1", "3", "10", "20"}
    for k, per in rw["rmse_by_k"].items():
        for metric, value in per.items():
            np.testing.assert_allclose(rg["rmse_by_k"][k][metric], value, rtol=1e-5,
                                       err_msg=f"k={k} {metric}")
    pw, pg = w["plan_with_learned_model"], g["plan_with_learned_model"]
    assert pg["budget"] == pw["budget"] == {"population": 128, "horizon": 30}
    np.testing.assert_allclose(pg["realized_returns"], pw["realized_returns"], rtol=1e-6)
    np.testing.assert_allclose(pg["mean_return"], pw["mean_return"], rtol=1e-6)
    assert got["verdict"] == want["verdict"]
    assert got["reference_points"]["tpu_v5e"] == {**want["reference_points"],
                                                  "source": "results/QUALITY_r05.json"}
    assert got["reference_points"]["verdict_anchor"] == "tpu_v5e"


def test_imagined_return_matches_with_identical_members(tmp_path, monkeypatch):
    # with every member equal, TS1 is the expectation in both packages
    want, got, _, _ = _run_both(tmp_path, monkeypatch, same_members=True)
    gw = want["phases"]["plan_with_learned_model"]["optimism_gap_per_episode"]
    gg = got["phases"]["plan_with_learned_model"]["optimism_gap_per_episode"]
    assert len(gg) == len(gw) == 1
    assert set(gg[0]) == set(gw[0]) == {"imagined_return", "realized_return"}
    assert np.isfinite(gg[0]["imagined_return"])
    np.testing.assert_allclose(gg[0]["imagined_return"], gw[0]["imagined_return"], rtol=1e-4)
    np.testing.assert_allclose(gg[0]["realized_return"], gw[0]["realized_return"], rtol=1e-6)


def _jax_verdict_texts() -> set:
    """The strings the JAX script assigns to ``verdict``."""
    with open(jax_diag.__file__) as f:
        tree = ast.parse(f.read())
    return {ast.literal_eval(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "verdict" for t in node.targets)}


def _table(path, row):
    path.write_text(json.dumps({"metric": "per_config_control_quality", "seeds": [0, 1, 2],
                                "configs": {"halfcheetah_running/ensemble-icem": row}}))
    return str(path)


def test_the_verdict_is_the_scripts_on_both_sides_of_the_anchor(tmp_path):
    assert _jax_verdict_texts() == {diag.DATA_COVERAGE, diag.COMPOUNDING_ERROR}
    assert diag.DATA_COVERAGE.startswith("DATA-COVERAGE")
    assert diag.COMPOUNDING_ERROR.startswith("COMPOUNDING-ERROR")
    v5e = diag.V5E_POINTS["onpolicy_quality_row_best"]
    assert diag.conclude(4 * v5e + 0.1)["verdict"] == diag.DATA_COVERAGE
    assert diag.conclude(4 * v5e)["verdict"] == diag.COMPOUNDING_ERROR
    anchor = diag.read_anchor(_table(tmp_path / "q.json", {
        "best_mean_return": 239.16, "final_mean_return": -83.13, "iterations_run": 30,
        "seeds": 3, "device": "cuda", "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    assert anchor["onpolicy_quality_row_best"] == 239.16 and anchor["iterations_run"] == 30
    # between 4x the port's row and 4x the v5e's, the anchor decides
    mid = 4 * 239.16 + 1.0
    port = diag.conclude(mid, anchor)
    assert port["verdict"] == diag.DATA_COVERAGE
    assert port["reference_points"]["verdict_anchor"] == "port"
    assert port["reference_points"]["port"] == anchor
    assert port["reference_points"]["tpu_v5e"]["onpolicy_quality_row_best"] == v5e
    assert diag.conclude(mid)["verdict"] == diag.COMPOUNDING_ERROR
    assert diag.conclude(4 * 239.16, anchor)["verdict"] == diag.COMPOUNDING_ERROR
    with pytest.raises(ValueError, match="best_mean_return"):
        diag.read_anchor(_table(tmp_path / "bad.json", {"error": "seed subprocess rc=1"}))


def test_quality_switch_anchors_the_verdict_on_the_ports_row(tmp_path, monkeypatch):
    table = _table(tmp_path / "q.json", {"best_mean_return": 100.0, "seeds": 3})
    calls = []

    def fake(device=None, anchor=None):
        calls.append((device, anchor))
        return {"phases": {}, **diag.conclude(450.0, anchor)}

    monkeypatch.setattr(diag, "diagnose", fake)
    out = tmp_path / "d.json"
    assert diag.main(["--out", str(out), "--device", "cpu", "--quality", table]) == 0
    block = json.loads(out.read_text())
    assert calls[0][0].type == "cpu" and calls[0][1]["onpolicy_quality_row_best"] == 100.0
    assert block["reference_points"]["verdict_anchor"] == "port"
    assert block["verdict"] == diag.DATA_COVERAGE and block["card"] is None
    assert diag.main(["--out", str(out), "--device", "cpu"]) == 0
    block = json.loads(out.read_text())
    assert calls[1][1] is None
    assert block["reference_points"]["verdict_anchor"] == "tpu_v5e"
    assert block["verdict"] == diag.COMPOUNDING_ERROR


def _finite_numbers(tree):
    if isinstance(tree, dict):
        return all(_finite_numbers(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_numbers(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return bool(np.isfinite(tree))
    return True


def test_a_tiny_run_on_the_cpu_writes_the_block(tmp_path, monkeypatch):
    # the real RolloutManager, controllers and training, cut to seconds
    monkeypatch.setattr(diag, "diagnose", functools.partial(
        diag.diagnose, n_random=1, n_expert=2, n_heldout=1, n_plan=1, ks=(1, 3),
        task_horizon=10, epochs=1, overrides=("controller_params.horizon=1",
                                              "controller_params.num_simulated_trajectories=6")))
    out = tmp_path / "d.json"
    assert diag.main(["--out", str(out), "--device", "cpu"]) == 0
    block = json.loads(out.read_text())
    assert set(block) == TOP_KEYS | {"card"}
    for phase, keys in PHASE_KEYS.items():
        assert set(block["phases"][phase]) == keys, phase
    assert block["device"] == "cpu" and block["card"] is None and block["task_horizon"] == 10
    assert _finite_numbers(block)
    assert len(block["phases"]["data"]["expert_returns"]) == 2
    assert block["phases"]["train"]["num_transitions"] == 10
    assert set(block["phases"]["open_loop_rmse"]["rmse_by_k"]) == {"1", "3"}
    assert block["phases"]["plan_with_learned_model"]["budget"] == {"population": 6,
                                                                     "horizon": 1}
    assert block["verdict"] in (diag.DATA_COVERAGE, diag.COMPOUNDING_ERROR)


def test_the_tool_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(diag, "diagnose", lambda *a, **k: pytest.fail("an episode ran"))
    with pytest.raises(RuntimeError, match="CUDA"):
        diag.main(["--out", str(tmp_path / "d.json")])
    assert not (tmp_path / "d.json").exists()
