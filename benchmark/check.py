"""The comparison that decides a run's ``correct``.

The program's outputs in the window are judged against the plain reference
of ``benchmark/reference/`` (frozen plain physics, the task's reward and
cost, plain iCEM), which imports nothing of the program and takes only the
inputs: the run's seed, and the program's own states and planner states at
the steps the check reads, since the reference follows the program step by
step from its own state. Numbers, each held to its limit in
``benchmark/limits/<cell>.json``:

- ``start_gap``: the episodes' first observations against the start states
  the reference draws from the same seed and stream (exact);
- ``step_gap``: the env's real step at the drawn steps, the program's next
  state and reward against the reference's step from the program's state
  and executed action;
- ``elite_cost_mismatch``: the planner's final elites at the drawn steps,
  their costs against the reference's open-loop rollout of the same action
  sequences from the same state (the rollout kernel's trajectories at the
  plan's shapes, the cost and the elite bookkeeping): the percent of elite
  rows whose cost gap exceeds ``ELITE_COST_TOL``. A share, not the widest
  gap: over 30 steps a contact met within roundoff sends a sound row's
  trajectory elsewhere now and then (sound runs on an H100 read gaps up
  to 0.09), while a lower-precision rollout moves every row;
- ``action_gap``: the executed action against the first action of the best
  elite (exact), and ``elite_order``, elites out of cost order (none);
- ``replay_mismatch``: the share of drawn steps whose plan step, replayed
  by the reference from the program's planner state and random stream
  with the full population, executes another action. The configuration's
  ``cem_loop`` names the order in which the program draws its noise
  (``reference/plan.py``); the replay covers the noise, the rollouts of
  every candidate, the masking of the decayed rows, the elite choice and
  the refit of mean and std.

Gaps are scaled: |program - reference| / (1 + |reference|), the widest.
The control is the reference itself in the program's place, computed in
bfloat16 (every float result rounded to bfloat16, ``Lower``).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from benchmark.reference import plan as ref_plan
from benchmark.reference import seeding

# a replayed step executes "another action" beyond this gap
REPLAY_ACTION_TOL = 1e-3
# an elite's cost "differs" beyond this scaled gap
ELITE_COST_TOL = 1e-2
# the reference runs on the host once the window has closed and the
# program's state is freed: its rows are few and its operations small, so
# the host's per-operation cost is below a launch on the card, and one
# thread runs them fastest
REFERENCE_DEVICE = torch.device("cpu")
REFERENCE_THREADS = 1


class Lower(TorchDispatchMode):
    """Round every floating result to bfloat16: the reference computed in
    the precision below the configuration's float32."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def round_(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(torch.bfloat16).to(x.dtype)
            return x

        return tree_map(round_, out)


def reference_task(cfg: dict, settings: dict):
    """The configuration's reference task under the settings as run."""
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return mod.Task(dict(settings.get("env_params", {})))


def scaled_gap(program, reference) -> float:
    p = torch.as_tensor(program, dtype=torch.float64)
    r = torch.as_tensor(reference, dtype=torch.float64)
    if p.numel() == 0:
        return 0.0
    gap = (p - r).abs() / (1.0 + r.abs())
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
    return float(gap.max())


def _complete(recorder, episodes) -> list:
    """The drawn steps whose state, planner states and next state were all
    read, inside the episode's valid transitions."""
    out = []
    for (ep, t), snap in sorted(recorder.snapshots.items()):
        if ep < len(episodes) and t + 1 < episodes[ep].steps and snap.after is not None \
                and snap.next_state is not None:
            out.append((ep, t, snap))
    return out


def numbers(cfg: dict, params, recorder, episodes, seed: int, control: bool = False) -> dict:
    """Every number compared, from the window's episodes and the recorder's
    snapshots; with ``control`` the program's outputs are replaced by the
    lower-precision reference's."""
    task = reference_task(cfg, params)
    dev = REFERENCE_DEVICE
    program_dev = recorder.device
    threads = torch.get_num_threads()
    torch.set_num_threads(REFERENCE_THREADS)
    try:
        return _numbers(cfg, params, task, recorder, episodes, seed, dev, program_dev, control)
    finally:
        torch.set_num_threads(threads)


def _numbers(cfg, params, task, recorder, episodes, seed, dev, program_dev, control) -> dict:
    out = {}
    with torch.inference_mode():
        out["start_gap"] = _start_gap(task, episodes, seed, program_dev)
        snaps = _complete(recorder, episodes)
        if not snaps:
            out["checked_steps"] = float("inf")  # nothing read: fails its limit
            return out
        states = torch.stack([s.state for _, _, s in snaps]).to(dev)
        nexts = torch.stack([s.next_state for _, _, s in snaps]).to(dev)
        actions = torch.as_tensor(np.stack([episodes[ep].data["actions"][t] for ep, t, _ in snaps]),
                                  dtype=torch.float32, device=dev)
        rewards = torch.as_tensor(np.array([episodes[ep].data["rewards"][t] for ep, t, _ in snaps]),
                                  dtype=torch.float32, device=dev)
        ref_next, _, ref_rew = ref_plan.step(task, states, actions)
        if control:
            with Lower():
                nexts, _, rewards = ref_plan.step(task, states, actions)
        out["step_gap"] = max(scaled_gap(nexts, ref_next), scaled_gap(rewards, ref_rew))

        # the program's final elites are rolled out beside the replay's first
        # iteration: the reference's time goes by horizon steps, not rows
        elites = torch.stack([s.after["elite_actions"] for _, _, s in snaps]).to(dev)
        costs = torch.stack([s.after["elite_costs"] for _, _, s in snaps]).to(dev)
        replay = _replay(cfg, params, task, snaps, states, elites, dev, program_dev)
        ref_a, ref_c = replay()
        judged = actions
        if control:
            with Lower():
                judged, costs = replay()
        ref = ref_c.double()
        gaps = (costs.double() - ref).abs() / (1.0 + ref.abs())
        out["elite_cost_mismatch"] = 100.0 * float((~(gaps <= ELITE_COST_TOL)).double().mean())
        out["action_gap"] = float((actions - elites[:, 0, 0]).abs().max())
        out["elite_order"] = float(sum(bool((torch.diff(c) < 0).any()) for c in costs))
        differ = (judged - ref_a).abs().amax(dim=1) > REPLAY_ACTION_TOL
        out["replay_mismatch"] = 100.0 * float(differ.float().mean())
    return out


def _start_gap(task, episodes, seed: int, program_dev) -> float:
    gap = 0.0
    for ep in episodes:
        gen = seeding.generator(seed, ep.env_stream, program_dev)
        want = task.observation(task.init_state(gen)).cpu()
        got = torch.as_tensor(ep.data["observations"][0])
        gap = max(gap, float((got - want).abs().max()))
    return gap


def _replay(cfg, params, task, snaps, states, elites, dev, program_dev):
    """A function that replays the drawn steps' plan steps from the
    program's planner and generator state, each call from the same state:
    (executed actions [S, A], the open-loop costs [S, K] of ``elites``)."""
    pcfg = ref_plan.Config(params["controller_params"], task.action_dim, task.low, task.high,
                           loop=cfg["cem_loop"])

    def gens():
        out = []
        for _, _, s in snaps:
            g = torch.Generator(device=program_dev)
            g.set_state(s.generator_state)
            out.append(g)
        return out

    def field(name):
        return torch.stack([s.before[name] for _, _, s in snaps]).to(dev)

    have = [s.before["have_elites"] for _, _, s in snaps]
    args = (states, field("mean"), field("std"), field("elite_actions"), field("elite_costs"), have)

    def replay():
        a, _, _, extra_costs = ref_plan.plan_steps(pcfg, task, gens(), *args, extra=elites)
        return a, extra_costs

    return replay
