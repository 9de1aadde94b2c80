"""Vanilla CEM's flat Door return is a real capability gap, not a wiring
fault: the counterpart of ``scripts/cem_door_sanity.py``.

    python -m icem_torch.tools.cem_door_sanity --out compare.json [--device cpu]
    SEEDS=0,1,2 BUDGET=64 TASK_HORIZON=200 \\
        python -m icem_torch.tools.cem_door_sanity --out compare.json

``compare_icem_cem.py`` shows CEM at -49.3 with std 0.0 on Door at every
budget and seed. With ``shaped_reward=False`` and the door never unlatched,
Door's cost is 0.1 (0 - 1.57)^2 + 1e-5 ||obs[-30:]||^2 a step: the first
term is the constant 0.24649 and the second is of order 1e-5, so a 200-step
failure returns -49.298 +- ~0.005 whatever the arm does, and the table's
one-decimal rounding collapses that to std 0.0.

This tool runs the CEM arm (``compare_icem_cem.make_planner``, on
``make_env("door")``) at one budget over the seeds, one device episode each,
and records per seed the unrounded return, the largest door angle reached
and the executed actions. It asserts, as the JAX script does:

- the seeds differ: their executed actions are more than 0.05 apart (RMS)
  and every episode's action std is above 0.05 (the planner is live, not a
  frozen mean);
- the door never opens: the largest angle stays below 0.2;
- the unrounded returns' std is below 0.05, and their mean is within 0.5 of
  the constant-cost prediction -0.1 * 1.57^2 * TASK_HORIZON (the JAX script
  records this as ``prediction_matches``; here it is held too).

Then it merges a ``cem_flatline_check`` block into ``--out`` (the table file
of ``compare_icem_cem.py``; everything else there is kept), with the
``device`` and ``card`` it ran on. The switches are the JAX script's:
``SEEDS`` (default ``0,1,2``), ``BUDGET`` (64) and ``TASK_HORIZON`` (200).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

STEP_COST = 0.1 * 1.57 ** 2   # the unshaped cost of a step with the door shut


def run_cem_door(budget: int, seed: int, task_horizon: int, device=None) -> dict:
    """One episode of vanilla CEM on the unshaped Door."""
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding
    from icem_torch.tools.compare_icem_cem import make_env, make_planner

    Seeding.set_seed(seed)
    env = make_env("door")
    ctrl = make_planner("cem", "door", env, budget, seed, device)
    man = RolloutManager(env, dict(task_horizon=task_horizon,
                                   use_env_states=True, fuse_on_device=True), device=device)
    r = man.sample(ctrl, mode="train", no_rollouts=1)[0]
    acts = np.asarray(r["actions"])                      # [T, A]
    door = np.asarray(r["next_observations"])[:, env.door_pos_idx[0]]
    return {
        "return": float(np.sum(r["rewards"])),
        "max_door_angle": float(np.max(door)),
        "action_std_within_episode": float(np.std(acts)),
        "actions": acts,
    }


def flatline_check(budget: int, seeds, task_horizon: int, device=None) -> dict:
    """Run the seeds and hold the assertions; the ``cem_flatline_check``
    block (without ``device`` and ``card``)."""
    per_seed = {s: run_cem_door(budget, s, task_horizon, device) for s in seeds}

    # the seeds must be different trajectories through action space even
    # though their returns collapse
    acts = [per_seed[s]["actions"] for s in seeds]
    cross = [float(np.sqrt(np.mean((acts[i] - acts[j]) ** 2)))
             for i in range(len(seeds)) for j in range(i + 1, len(seeds))]
    rets = np.array([per_seed[s]["return"] for s in seeds])
    max_door = max(per_seed[s]["max_door_angle"] for s in seeds)
    predicted = -STEP_COST * task_horizon

    checks = {
        "seeds_differ_rms_action_distance": round(float(np.mean(cross)), 4),
        "within_episode_action_std": round(float(np.mean(
            [per_seed[s]["action_std_within_episode"] for s in seeds])), 4),
        "max_door_angle_any_seed": round(max_door, 4),
        "returns_unrounded": [round(float(r), 4) for r in rets],
        "returns_std_unrounded": round(float(np.std(rets)), 5),
        "constant_cost_prediction": round(predicted, 3),
    }
    assert np.mean(cross) > 0.05, \
        f"seeds produced near-identical actions ({cross}): a wiring fault"
    assert all(per_seed[s]["action_std_within_episode"] > 0.05 for s in seeds), \
        "CEM executed a frozen mean: a wiring fault"
    assert max_door < 0.2, \
        f"the door moved (max angle {max_door}): the flatline is not a capability gap"
    assert np.std(rets) < 0.05, \
        f"the returns vary more than the rounding band ({rets})"
    ok = abs(float(np.mean(rets)) - predicted) < 0.5
    assert ok, f"mean return {float(np.mean(rets))} is not the constant cost {predicted}"

    notes = (
        "cem flatline verified as a real capability gap: seeds execute different actions "
        f"(cross-seed RMS distance {checks['seeds_differ_rms_action_distance']}, "
        f"within-episode std {checks['within_episode_action_std']}) but the door never "
        f"moves (max angle {checks['max_door_angle_any_seed']}), so the unshaped cost is "
        f"the constant 0.1*1.57^2 per step -> return {checks['constant_cost_prediction']} "
        "+- O(1e-2) from the 1e-5 velocity term; 1-decimal rounding collapses that to "
        "std 0.0.")
    return {"budget": budget, "seeds": list(seeds), "task_horizon": task_horizon,
            "prediction_matches": ok, **checks, "notes": notes}


def main(argv=None) -> int:
    from icem_torch.device import resolve_device
    from icem_torch.tools.quality_table import card_name

    ap = argparse.ArgumentParser(prog="python -m icem_torch.tools.cem_door_sanity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="the JSON file the block is merged into; the rest is kept")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    budget = int(os.environ.get("BUDGET", "64"))
    seeds = [int(s) for s in os.environ.get("SEEDS", "0,1,2").split(",")]
    task_horizon = int(os.environ.get("TASK_HORIZON", "200"))

    block = flatline_check(budget, seeds, task_horizon, device)
    block.update(device=device.type, card=card_name(device))
    data = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            data = json.load(f)
    data["cem_flatline_check"] = block
    with open(args.out, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(block))
    return 0


if __name__ == "__main__":
    sys.exit(main())
