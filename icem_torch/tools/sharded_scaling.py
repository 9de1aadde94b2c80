"""The sharded planner across cards: one process per card, from CUDA graphs
and eagerly.

    ICEM_MULTIHOST=1 torchrun --nproc-per-node N -m icem_torch.tools.sharded_scaling \\
        [--out results.json] [--device cpu]

Every rank, over the group of all ranks (``controller_params.sharded=true``):

1. runs ``settings/halfcheetah_running/i-cem-blitz.json`` through
   ``icem_torch.main.run`` (one iteration, its episode cut to
   EPISODE_STEPS), from CUDA graphs and then eagerly (``eager=True``),
   each under a ``model_dir`` of its own. Held: every rank's actions are
   rank 0's bits, and the graph run's are the eager run's;
2. times ``MpcICem.get_action`` (a plan step and its read-back) at bench.py's
   population, 32,768 trajectories and 512 elites over the same settings,
   from graphs and eagerly: the median of PLAN_STEPS steps after the
   first two, on the host clock after ``torch.cuda.synchronize()``. The
   ranks' actions are held to rank 0's bits here too.

Rank 0 prints one JSON line (and writes it to ``--out``): the world size,
the card's name, and per part the readings of every rank (``measure``).
``--device cpu`` runs the same program over gloo on the CPU, slowly at these
sizes; ``tests/test_torch_parallel.py`` runs ``measure`` at two gloo ranks
at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

SETTINGS = "settings/halfcheetah_running/i-cem-blitz.json"
# bench.py's population over the shipped structure (chip_smoke.py's main path)
BENCH_WIDTHS = ("controller_params.num_simulated_trajectories=32768",
                "controller_params.action_sampler_params.elites_size=512")
SEED = 0
EPISODE_STEPS = 100  # control steps of each driver run
PLAN_STEPS = 20  # timed plan steps each way


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _same_on_every_rank(x: np.ndarray) -> bool:
    """Whether every rank holds ``x``'s bits (held on every rank)."""
    xs = [None] * dist.get_world_size()
    dist.all_gather_object(xs, x)
    return all(np.array_equal(y, xs[0]) for y in xs)


def driver_runs(device, episode_steps: int) -> dict:
    """Part 1: the driver from graphs and eagerly; the actions and returns."""
    import pickle

    from icem_torch import main as tmain
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    out = {}
    for mode in ("graph", "eager"):
        with tempfile.TemporaryDirectory() as model_dir:
            params = apply_overrides(resolve_settings(SETTINGS), [
                "controller_params.sharded=true", "training_iterations=1",
                f"rollout_params.task_horizon={episode_steps}", f"seed={SEED}",
                f"model_dir={model_dir}"])
            _sync(device)
            t0 = time.perf_counter()
            info = tmain.run(params, device=device, eager=mode == "eager")
            _sync(device)
            wall = time.perf_counter() - t0
            with open(os.path.join(model_dir, "checkpoints_latest", "rollout_buffer.pkl"),
                      "rb") as f:
                actions = np.concatenate([r["actions"] for r in pickle.load(f)])
        out[mode] = dict(actions=actions, ret=float(info["train_mean_return"][-1]),
                         ms=float(np.sum(info["train_exec_time"])) * 1e3 / episode_steps,
                         wall_s=wall)
    return out


def plan_step_times(device, plan_steps: int, widths=BENCH_WIDTHS) -> dict:
    """Part 2: ms per ``get_action`` at ``widths``, from graphs and eagerly,
    and the actions of each mode."""
    from icem_torch.envs import env_from_string
    from icem_torch.main import get_controllers
    from icem_torch.models import forward_model_from_string
    from icem_torch.runtime.config import apply_overrides, resolve_settings
    from icem_torch.runtime.graphs import disable_graphs
    from icem_torch.runtime.seeding import Seeding

    params = apply_overrides(resolve_settings(SETTINGS), [
        "controller_params.sharded=true", f"seed={SEED}", *widths])
    out = {}
    for mode in ("graph", "eager"):
        Seeding.set_seed(SEED)  # the same planner streams both ways
        env = env_from_string(params.env, **params.get("env_params", {}))
        model = forward_model_from_string(params.forward_model)(
            env=env, device=device, **params.get("forward_model_params", {}))
        ctrl = get_controllers(params, env, model, device)[1]
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        state = env.init_state(gen)
        obs = env.observation(state)
        ms, actions = [], []
        with disable_graphs() if mode == "eager" else contextlib.nullcontext():
            ctrl.beginning_of_rollout(observation=obs, state=state)
            for _ in range(plan_steps):
                _sync(device)
                t0 = time.perf_counter()
                a = ctrl.get_action(obs, state)
                _sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                actions.append(a)
                state, obs, _, _ = env.step(state, torch.as_tensor(a, device=device))
        out[mode] = dict(ms=float(np.median(ms[2:])), ms_all=ms, actions=np.stack(actions),
                         trajectories=ctrl.cfg.num_simulated_trajectories,
                         rows_per_rank=-(-ctrl.cfg.num_simulated_trajectories
                                         // ctrl._group.size))
    return out


def measure(device, episode_steps: int = EPISODE_STEPS, plan_steps: int = PLAN_STEPS,
            widths=BENCH_WIDTHS) -> dict:
    """Both parts on this rank, over the group of all ranks: this rank's
    readings, and what it held (``held``, every value True if all is well)."""
    runs = driver_runs(device, episode_steps)
    times = plan_step_times(device, plan_steps, widths)
    held = {
        "ranks_agree_driver": _same_on_every_rank(runs["graph"]["actions"]),
        "ranks_agree_plan": _same_on_every_rank(times["graph"]["actions"]),
        "graph_is_eager_driver": bool(np.array_equal(runs["graph"]["actions"],
                                                     runs["eager"]["actions"])
                                      and runs["graph"]["ret"] == runs["eager"]["ret"]),
        "graph_is_eager_plan": bool(np.array_equal(times["graph"]["actions"],
                                                   times["eager"]["actions"])),
    }
    return dict(rank=dist.get_rank(), held=held,
                driver={m: {k: v for k, v in r.items() if k != "actions"}
                        for m, r in runs.items()},
                plan={m: {k: v for k, v in r.items() if k != "actions"}
                      for m, r in times.items()})


def main(argv=None) -> int:
    from icem_torch.device import resolve_device
    from icem_torch.parallel.multihost import maybe_initialize_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="where rank 0 writes its JSON line")
    ap.add_argument("--device", default=None, help="cpu: run over gloo on the CPU")
    args = ap.parse_args(argv)

    if not maybe_initialize_distributed(device=args.device):
        raise SystemExit("sharded_scaling: no process group; launch with ICEM_MULTIHOST=1 "
                         "torchrun --nproc-per-node N")
    device = resolve_device(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = measure(device)
    every = [None] * world
    dist.all_gather_object(every, mine)
    ok = all(all(r["held"].values()) for r in every)
    if rank == 0:
        import subprocess

        card = "cpu"
        if device.type == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader", "-i", str(device.index or 0)],
                                  capture_output=True, text=True).stdout.strip()
        line = json.dumps(dict(world=world, card=card, torch=torch.__version__,
                               settings=SETTINGS, widths=BENCH_WIDTHS,
                               episode_steps=EPISODE_STEPS, ok=ok, ranks=every))
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
