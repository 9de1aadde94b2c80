"""Diagnose why the learned-model HalfCheetah trails its ground-truth twin.

The counterpart of ``scripts/ensemble_diagnosis.py``:

    python -m icem_torch.tools.ensemble_diagnosis --out diag.json [--device cpu] \\
        [--quality table.json]

``halfcheetah_running/ensemble-icem`` plans through a learned ensemble on the
env's analytic cost (the learned reward head is out of the loop), and its
quality-table row sits far below ``halfcheetah_running/i-cem-blitz``, the same
planner on the ground-truth model. Two causes fit: data coverage (the
on-policy data never reaches fast-gait states) or compounding model error
(CEM exploits the model's errors over the h = 30 open-loop horizon). One
controlled experiment separates them, phase for phase as the JAX script:

A. data: 5 episodes of the ``random`` controller, then 8 expert episodes of
   the ground-truth i-cem-blitz controller, on the ensemble config's env
   (x-position in the observation, the flip penalty) for both;
B. train the shipped ``EnsembleModel`` (the config's widths and epochs) on
   every episode but the last random one and the last 2 expert ones;
C1. k-step open-loop RMSE on those held-out episodes, from a start every 50
   steps, with the members' mean (``propagation = "expectation"``): over all
   observation dims and on the forward velocity (``obs_dim // 2``, the dim
   ``HalfCheetah.cost_fn`` pays for);
C2. plan through the trained model with the ensemble-icem controller (TS1
   again) for 2 episodes: the realized returns, and the model-optimism gap,
   the imagined return of each episode's executed actions from its first
   observation against the realized one.

The verdict is the JAX script's rule: DATA-COVERAGE if the expert-trained
planner's mean return exceeds 4x the on-policy row's best return, else
COMPOUNDING-ERROR. The script's anchor is a TPU v5e row
(``results/QUALITY_r05.json``); it stays in ``reference_points`` under that
label. ``--quality FILE`` reads the port's own
``halfcheetah_running/ensemble-icem`` row from a table written by
``icem_torch/tools/quality_table.py`` and takes the verdict against its
``best_mean_return`` instead; ``reference_points.verdict_anchor`` names the
anchor used.

The JSON goes to ``--out`` with the script's keys and ``card`` (the card's
name and power limit as nvidia-smi prints them; null on the CPU). Numbers
are written unrounded. The episodes run as device episodes, from CUDA graphs
on the card. The sizes are ``diagnose``'s parameters; ``main`` runs the
script's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N_RANDOM = 5
N_EXPERT = 8
N_HELDOUT_EXPERT = 2   # of the N_EXPERT, kept out of training
N_PLAN_EPISODES = 2
KS = (1, 3, 5, 10, 20, 30)
START_EVERY = 50       # steps between open-loop starts in a held-out episode

GT_CONFIG = "halfcheetah_running/i-cem-blitz"
ENSEMBLE_CONFIG = "halfcheetah_running/ensemble-icem"
# the JAX script's anchors, measured on a TPU v5e (scripts/ensemble_diagnosis.py:200-201)
V5E_POINTS = {"onpolicy_quality_row_best": 458.3,  # ensemble-icem best, 31 iterations
              "gt_twin_final": 7080.4}             # i-cem-blitz final

DATA_COVERAGE = (
    "DATA-COVERAGE blocker: the shipped model class supports "
    "fast-gait planning once trained on expert-state data — "
    "the on-policy protocol's 36 episodes simply haven't "
    "bootstrapped that distribution yet (PETS-class sample "
    "complexity, not a code defect).")
COMPOUNDING_ERROR = (
    "COMPOUNDING-ERROR blocker: even expert-state training "
    "does not make h=30 open-loop imagination faithful enough "
    "for CEM not to exploit it (see optimism gap / k-step "
    "velocity RMSE) — the known PETS-class limitation; levers "
    "are shorter effective horizon, uncertainty-penalized "
    "cost, or an RSSM-style latent model.")


def verdict(mean_return: float, onpolicy_best: float) -> str:
    """The JAX script's rule and text."""
    return DATA_COVERAGE if mean_return > 4 * onpolicy_best else COMPOUNDING_ERROR


def read_anchor(path: str) -> dict:
    """The port's ``halfcheetah_running/ensemble-icem`` row of a quality
    table, as the verdict's anchor."""
    with open(path) as f:
        row = json.load(f).get("configs", {}).get(ENSEMBLE_CONFIG)
    if row is None or row.get("best_mean_return") is None:
        raise ValueError(f"{path} has no {ENSEMBLE_CONFIG} row with a best_mean_return: {row}")
    return {"onpolicy_quality_row_best": row["best_mean_return"],
            "final_mean_return": row.get("final_mean_return"),
            "iterations_run": row.get("iterations_run"),
            "seeds": row.get("seeds", 1),
            "device": row.get("device"),
            "card": row.get("card"),
            "source": os.path.abspath(path)}


def conclude(mean_return: float, anchor: dict | None = None) -> dict:
    """``reference_points`` and ``verdict``: against the port's row where
    ``anchor`` (``read_anchor``) is given, else against the v5e's."""
    points = {"tpu_v5e": {**V5E_POINTS, "source": "results/QUALITY_r05.json"}}
    if anchor is not None:
        points["port"] = anchor
        points["verdict_anchor"] = "port"
    else:
        points["verdict_anchor"] = "tpu_v5e"
    best = points[points["verdict_anchor"]]["onpolicy_quality_row_best"]
    return {"reference_points": points, "verdict": verdict(mean_return, best)}


def _returns(episodes) -> list:
    return [float(np.sum(r["rewards"])) for r in episodes]


def open_loop_rmse(model, held_eps, ks, vel_idx: int, device) -> dict:
    """k-step open-loop RMSE of the members' mean over every start of every
    held-out episode: {k: {"all": [per episode], "fwd_vel": [...]}}. The
    starts of all episodes go to the device in one copy and through one
    rollout; the errors are taken per episode, as the JAX script takes them."""
    import torch

    from icem_torch.device import on_device
    from icem_torch.models.base import broadcast_model_state, rollout_open_loop

    h = max(ks)
    o0, acts, truths = [], [], []
    for ep in held_eps:
        obs = np.asarray(ep["observations"], np.float32)
        act = np.asarray(ep["actions"], np.float32)
        next_obs = np.asarray(ep["next_observations"], np.float32)
        starts = np.arange(0, len(obs) - h, START_EVERY)
        if not len(starts):
            continue
        o0.append(obs[starts])
        acts.append(np.stack([act[s:s + h] for s in starts]))
        truths.append(np.stack([next_obs[s:s + h] for s in starts], axis=1))  # [h, p, obs]
    per_k = {k: {"all": [], "fwd_vel": []} for k in ks}
    if not o0:
        return per_k
    o0_t, acts_t = on_device((np.concatenate(o0), np.concatenate(acts)), device)
    # propagation is read at call time (EnsembleModel.apply_fn): this pass
    # runs eagerly, and TS1 is back before anything else plans
    model.propagation = "expectation"
    try:
        with torch.no_grad():
            ms = broadcast_model_state(model.init_model_state(None), o0_t.shape[0])
            traj = rollout_open_loop(model.predict_fn, ms, o0_t, acts_t)
            pred_all = traj.next_observations.cpu().numpy()  # [h, p, obs]
    finally:
        model.propagation = "ts1"
    first = 0
    for true in truths:
        pred = pred_all[:, first:first + true.shape[1]]
        first += true.shape[1]
        err = pred - true
        for k in ks:
            per_k[k]["all"].append(np.sqrt(np.mean(err[k - 1] ** 2)))
            per_k[k]["fwd_vel"].append(np.sqrt(np.mean(err[k - 1][:, vel_idx] ** 2)))
    return per_k


def imagined_returns(model, env, episodes, device) -> list:
    """The model-imagined return of each episode's executed actions from its
    first observation (TS1, the planner's propagation), beside the realized
    return."""
    import torch

    from icem_torch.device import on_device
    from icem_torch.models.base import broadcast_model_state, rollout_open_loop

    arrays = []
    for ep in episodes:
        arrays += [np.asarray(ep["observations"], np.float32)[0],
                   np.asarray(ep["actions"], np.float32)]
    on_dev = on_device(arrays, device)
    gaps = []
    with torch.no_grad():
        for ep, obs0, acts in zip(episodes, on_dev[0::2], on_dev[1::2]):
            ms = broadcast_model_state(model.init_model_state(None), 1)
            traj = rollout_open_loop(model.predict_fn, ms, obs0[None], acts[None])
            imag_cost = env.cost_fn(traj.observations[:, 0], traj.actions[:, 0],
                                    traj.next_observations[:, 0])
            gaps.append({"imagined_return": float(-torch.sum(imag_cost)),
                         "realized_return": float(np.sum(ep["rewards"]))})
    return gaps


def diagnose(n_random: int = N_RANDOM, n_expert: int = N_EXPERT,
             n_heldout: int = N_HELDOUT_EXPERT, n_plan: int = N_PLAN_EPISODES, ks=KS,
             task_horizon: int | None = None, epochs: int | None = None, overrides=(),
             device=None, anchor: dict | None = None) -> dict:
    """The whole experiment: the output block without ``card``.

    ``task_horizon`` (default the ensemble config's 1,000) is every episode's
    length, ``epochs`` (default the config's 25) the training epochs;
    ``overrides``: ``key=value`` settings overrides applied to both configs
    (a smaller planner on the CPU). ``anchor``: ``read_anchor``'s row, the
    verdict's anchor (default the v5e's)."""
    from icem_torch.controllers import controller_from_string
    from icem_torch.device import resolve_device
    from icem_torch.envs import env_from_string
    from icem_torch.models import forward_model_from_string
    from icem_torch.models.ensemble import EnsembleModel
    from icem_torch.runtime.buffer import RolloutBuffer
    from icem_torch.runtime.config import apply_overrides, resolve_settings
    from icem_torch.runtime.rollout import RolloutManager, compute_reward_info
    from icem_torch.runtime.seeding import Seeding
    from icem_torch.tools.quality_table import SETTINGS_DIR

    device = resolve_device(device)
    Seeding.set_seed(0)
    gt_params, ens_params = (
        apply_overrides(resolve_settings(os.path.join(SETTINGS_DIR, name + ".json")),
                        list(overrides))
        for name in (GT_CONFIG, ENSEMBLE_CONFIG))

    # the ensemble config's env (x-position in obs, flip penalty) for BOTH
    # data collection and planning, so the datasets share one obs layout
    env = env_from_string(ens_params.env, **ens_params.get("env_params", {}))
    rollout_params = dict(ens_params.rollout_params)
    if task_horizon is not None:
        rollout_params["task_horizon"] = int(task_horizon)
    task_horizon = int(rollout_params["task_horizon"])
    rollout_man = RolloutManager(env, rollout_params, device=device)
    out = {"what": __doc__.split("\n")[0], "env": ens_params.env,
           "task_horizon": task_horizon, "device": device.type, "phases": {}}

    # ---- A. data ----------------------------------------------------------
    t0 = time.time()
    gt_model = forward_model_from_string(gt_params.forward_model)(env=env)
    gt_ctrl = controller_from_string(gt_params.controller)(
        env=env, forward_model=gt_model, device=device, **dict(gt_params.controller_params))
    rnd_ctrl = controller_from_string("random")(env=env, device=device)
    rollout_man.set_epoch(0)
    random_eps = rollout_man.sample(rnd_ctrl, mode="train", name="diag_rnd",
                                    no_rollouts=n_random)
    rollout_man.set_epoch(1)
    expert_eps = rollout_man.sample(gt_ctrl, mode="train", name="diag_exp",
                                    no_rollouts=n_expert)
    out["phases"]["data"] = {
        "random_episodes": n_random, "expert_episodes": n_expert,
        "expert_returns": _returns(expert_eps), "random_returns": _returns(random_eps),
        "wall_s": time.time() - t0,
    }
    print("expert returns:", out["phases"]["data"]["expert_returns"], file=sys.stderr)

    # ---- B. train ---------------------------------------------------------
    t0 = time.time()
    train_buf = RolloutBuffer(rollouts=list(random_eps[:-1]) + list(expert_eps[:-n_heldout]))
    held_eps = list(expert_eps[-n_heldout:]) + [random_eps[-1]]
    fm_params = dict(ens_params.get("forward_model_params", {}))
    if epochs is not None:
        fm_params["epochs"] = int(epochs)
    model = EnsembleModel(env=env, seed=0, device=device, **fm_params)
    train_info = model.train(train_buf)
    out["phases"]["train"] = {**train_info, "wall_s": time.time() - t0}
    print("train:", out["phases"]["train"], file=sys.stderr)

    # ---- C1. k-step open-loop RMSE on held-out episodes -------------------
    t0 = time.time()
    # qpos block then qvel block; the first qvel entry is the forward (x)
    # velocity the running cost pays for
    vel_idx = env.observation_space.dim // 2
    per_k = open_loop_rmse(model, held_eps, ks, vel_idx, device)
    true_vel_scale = float(np.sqrt(np.mean(
        np.asarray(held_eps[0]["observations"], np.float32)[:, vel_idx] ** 2)))
    out["phases"]["open_loop_rmse"] = {
        "heldout_episodes": len(held_eps), "starts_per_ep_every": START_EVERY,
        "fwd_vel_obs_index": int(vel_idx),
        "true_fwd_vel_rms": true_vel_scale,
        "rmse_by_k": {str(k): {m: float(np.mean(v)) for m, v in per_k[k].items()}
                      for k in ks},
        "wall_s": time.time() - t0,
    }
    print("rmse:", json.dumps(out["phases"]["open_loop_rmse"]["rmse_by_k"]), file=sys.stderr)

    # ---- C2. plan through the trained model ------------------------------
    t0 = time.time()
    # built after train() and with TS1 back: its plan step reads the live
    # weights and is captured under the planner's propagation
    ens_ctrl = controller_from_string(ens_params.controller)(
        env=env, forward_model=model, device=device, **dict(ens_params.controller_params))
    rollout_man.set_epoch(2)
    plan_eps = rollout_man.sample(ens_ctrl, mode="train", name="diag_plan",
                                  no_rollouts=n_plan)
    info = compute_reward_info(RolloutBuffer(rollouts=list(plan_eps)), prefix="")
    out["phases"]["plan_with_learned_model"] = {
        "budget": {"population": int(ens_params.controller_params["num_simulated_trajectories"]),
                   "horizon": int(ens_params.controller_params["horizon"])},
        "episodes": n_plan,
        "realized_returns": _returns(plan_eps),
        "mean_return": float(info["mean_return"]),
        "optimism_gap_per_episode": imagined_returns(model, env, plan_eps, device),
        "wall_s": time.time() - t0,
    }
    print("plan:", json.dumps(out["phases"]["plan_with_learned_model"]), file=sys.stderr)

    out.update(conclude(float(info["mean_return"]), anchor))
    print("VERDICT:", out["verdict"], file=sys.stderr)
    return out


def main(argv=None) -> int:
    from icem_torch.device import resolve_device
    from icem_torch.runtime import metrics
    from icem_torch.tools.quality_table import card_name

    ap = argparse.ArgumentParser(prog="python -m icem_torch.tools.ensemble_diagnosis",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the JSON file the diagnosis is written to")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default: the CUDA device")
    ap.add_argument("--quality", default=None,
                    help="a quality_table.py table whose halfcheetah_running/ensemble-icem "
                         "row anchors the verdict (default: the v5e's row)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device cpu: raise here
    anchor = read_anchor(args.quality) if args.quality else None

    before = metrics.counters()
    out = diagnose(device=device, anchor=anchor)
    out["card"] = card_name(device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"B1 launches: {metrics.since(before).get('b1.launches', 0)}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
