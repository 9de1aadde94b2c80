"""iCEM against vanilla CEM at equal sample budgets, the counterpart of
``scripts/compare_icem_cem.py`` (the paper's headline: iCEM needs far fewer
samples than CEM).

    python -m icem_torch.tools.compare_icem_cem --out compare.json [--device cpu]
    ENVS=door BUDGETS=40,120,400 SEEDS=0,1,2 \\
        python -m icem_torch.tools.compare_icem_cem --out compare.json

Two envs: HalfCheetah (return against the budget) and Door (success against
the budget, the hard-exploration regime). Both planners run device episodes
(``RolloutManager`` with ``fuse_on_device``) at the same trajectory budget a
step: ``MpcICem`` with the i-cem-blitz structure, ``MpcCemStd`` with white
truncated-normal noise, a fixed population and no elite memory. The
switches are the JAX script's: ``ENVS`` (default ``halfcheetah,door``),
``BUDGETS`` (``8,16,32,64,128``), ``SEEDS`` (``0,1,2``), ``EPISODES`` (3 a
seed) and ``TASK_HORIZON`` (default per env, ``PLANNER``). The envs, the
planners and the output layout are the JAX script's
(``tests/test_torch_compare_icem_cem.py`` holds them against it); each env's
table also names the ``device`` and the ``card`` (name and power limit, as
``nvidia-smi`` prints them; null on the CPU).

The table goes to ``--out`` after every budget; envs already in that file
and not run again are kept. The JAX script's persistent compile cache is the
TPU's and has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def make_env(env_name: str):
    if env_name == "halfcheetah":
        from icem_torch.envs.cheetah import HalfCheetah
        return HalfCheetah(exclude_current_positions_from_observation=False,
                           penalise_flipping=True)
    if env_name == "door":
        from icem_torch.envs.adroit import Door
        return Door(shaped_reward=False)
    raise ValueError(env_name)


# per-env planner structure: i-cem-blitz / cem-std analogs of the shipped
# settings (noise_beta per settings/<env>/i-cem-blitz.json)
PLANNER = {
    "halfcheetah": dict(horizon=30, noise_beta=0.25, task_horizon=100),
    "door": dict(horizon=30, noise_beta=2.5, task_horizon=200),
}


def make_planner(kind: str, env_name: str, env, budget: int, seed: int = 0, device=None):
    """The planner at ``budget`` trajectories a step: ``MpcICem`` with the
    env's i-cem-blitz structure, or vanilla CEM (``MpcCemStd``)."""
    from icem_torch.controllers.cem_std import MpcCemStd
    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel

    model = GroundTruthModel(env=env)
    spec = PLANNER[env_name]
    if kind == "icem":
        return MpcICem(env=env, forward_model=model, horizon=spec["horizon"],
                       num_simulated_trajectories=budget,
                       factor_decrease_num=1.25, seed=seed, device=device,
                       action_sampler_params=dict(
                           noise_beta=spec["noise_beta"],
                           elites_size=max(2, budget // 4)))
    return MpcCemStd(env=env, forward_model=model, horizon=spec["horizon"],
                     num_simulated_trajectories=budget, seed=seed, device=device,
                     action_sampler_params=dict(
                         opt_iterations=3,
                         elites_size=max(2, budget // 4)))


def run_planner(kind: str, env_name: str, budget: int, episodes: int,
                task_horizon: int, seed: int = 0, device=None):
    """``episodes`` episodes of one planner at ``budget`` trajectories a
    step: (returns, successes), successes None where the env has none."""
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding

    Seeding.set_seed(seed)
    env = make_env(env_name)
    ctrl = make_planner(kind, env_name, env, budget, seed, device)
    man = RolloutManager(env, dict(task_horizon=task_horizon,
                                   use_env_states=True, fuse_on_device=True), device=device)
    rollouts = man.sample(ctrl, mode="train", no_rollouts=episodes)
    returns = [float(np.sum(r["rewards"])) for r in rollouts]
    successes = None
    # solved if any step of the episode meets the success predicate; the
    # rollouts hold host arrays, the predicate takes tensors
    flags = [env.is_success(*(torch.as_tensor(r[k]) for k in
                              ("observations", "actions", "next_observations")))
             for r in rollouts]
    if all(f is not None for f in flags):
        successes = [float(torch.max(f)) for f in flags]
    return returns, successes


def compare_row(env_name: str, budget: int, seeds, episodes: int, task_horizon: int,
                device=None) -> dict:
    """One budget's row: each planner's mean and std return over every
    episode of every seed, and its success rate where the env has one."""
    row = {}
    for kind in ("icem", "cem"):
        rets, succ = [], []
        for seed in seeds:
            r, s = run_planner(kind, env_name, budget, episodes, task_horizon, seed, device)
            rets += r
            if s is not None:
                succ += s
        row[f"{kind}_return"] = round(float(np.mean(rets)), 1)
        row[f"{kind}_return_std"] = round(float(np.std(rets)), 1)
        if succ:
            row[f"{kind}_success"] = round(float(np.mean(succ)), 3)
    return row


def main(argv=None) -> int:
    from icem_torch.device import resolve_device
    from icem_torch.tools.quality_table import card_name

    ap = argparse.ArgumentParser(prog="python -m icem_torch.tools.compare_icem_cem",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the table's JSON file; envs already "
                                                 "there and not run again are kept")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    env_names = os.environ.get("ENVS", "halfcheetah,door").split(",")
    budgets = [int(b) for b in os.environ.get("BUDGETS", "8,16,32,64,128").split(",")]
    seeds = [int(s) for s in os.environ.get("SEEDS", "0,1,2").split(",")]
    episodes = int(os.environ.get("EPISODES", 3))

    out = {"metric": "icem_vs_cem",
           "episodes_per_seed": episodes, "seeds": seeds, "envs": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out["envs"] = json.load(f).get("envs", {})

    for env_name in env_names:
        task_horizon = int(os.environ.get("TASK_HORIZON", PLANNER[env_name]["task_horizon"]))
        table = {"task_horizon": task_horizon, "device": device.type, "card": card}
        for b in budgets:
            row = compare_row(env_name, b, seeds, episodes, task_horizon, device)
            table[b] = row
            print(f"[{env_name}] budget {b:4d}: {json.dumps(row)}", file=sys.stderr, flush=True)
            out["envs"][env_name] = table
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
