"""Peaks, operation counts and roofline bounds of the rollout kernels.

The operations of a trajectory-step are counted on the frozen plain physics
of ``benchmark/reference/`` (one per output element of each arithmetic or
comparison operation it dispatches; data movement counts as bytes): its
row engines have no data-dependent branch, so the count does not depend on
the inputs and scales exactly with rows x steps. Each configuration file
records its count (``ops_per_trajectory_step``), which a CPU test holds to
this counter. A rollout's bytes: each input read once (start states and
actions), each output written once (the states of every step).

A control step needs the rollouts the iCEM algorithm asks for, whatever
loop implements them: at the first iteration the fresh population and the
shifted elites, at each later one its decayed population (kept elites are
not re-simulated), and the real step (one row, one step).
"""

from __future__ import annotations

import collections

import torch

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
              "sin", "cos", "clamp", "clamp_min", "clamp_max", "maximum",
              "minimum", "where", "sign", "lt", "gt", "le", "ge", "bitwise_or"}


def plain_ops_per_trajectory_step(engine, model) -> float:
    """Arithmetic operations of ``engine.rollout`` (a frozen plain engine) for
    one trajectory and one control step of ``model``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in _ARITH_OPS:
                self.ops[func.overloadpacket.__name__] += out.numel()
            return out

    P, h = 64, 1
    nd, na = model.ndof, len(model.actuator_dof)
    Q = torch.zeros((P, nd))
    A = torch.zeros((P, h, na))
    with Counter() as counter:
        engine.rollout(model, Q, Q, A)
    return sum(counter.ops.values()) / (P * h)


def rollout_bytes(P: int, h: int, nd: int, na: int) -> int:
    return 4 * (2 * nd * P + P * h * na + 2 * h * P * nd)


def rollout_bound_s(ops_per_traj_step: float, P: int, h: int, nd: int, na: int) -> float:
    """The least time a rollout of P rows over h steps can take on the card:
    operations over the FP32 peak against bytes over the HBM rate."""
    return max(ops_per_traj_step * P * h / PEAK_FP32_FLOPS,
               rollout_bytes(P, h, nd, na) / PEAK_HBM_BYTES_PER_S)


def rollouts_per_control_step(controller_params: dict) -> list:
    """[(rows, steps)] of the rollouts one control step of iCEM needs."""
    p = dict(controller_params)
    s = dict(p.get("action_sampler_params", {}))
    n, h = int(p.get("num_simulated_trajectories", 40)), int(p.get("horizon", 30))
    decay = float(p.get("factor_decrease_num", 1.25))
    elites_size = int(s.get("elites_size", 10))
    num_elites = max(min(elites_size, n // 2), 2)
    kept = int(num_elites * float(s.get("fraction_elites_reused", 0.3)))
    shift = bool(s.get("shift_elites_over_time", True))
    out = []
    for i in range(int(s.get("opt_iterations", 3))):
        if i > 0:
            n = max(elites_size * 2, int(n / decay))
        out.append((n + (kept if i == 0 and shift else 0), h))
    out.append((1, 1))
    return out


def control_step_ops(cfg: dict) -> float:
    """Rollout operations of one control step."""
    k = cfg["kernel"]
    return sum(k["ops_per_trajectory_step"] * P * h
               for P, h in rollouts_per_control_step(cfg["settings"]["controller_params"]))


def control_step_bound_s(cfg: dict) -> float:
    """The roofline bound of one control step's rollouts, launch by launch."""
    k = cfg["kernel"]
    return sum(rollout_bound_s(k["ops_per_trajectory_step"], P, h, k["ndof"], k["nact"])
               for P, h in rollouts_per_control_step(cfg["settings"]["controller_params"]))


def kernel_share(run, family: str):
    """Percent of the kernel's traced device time that its roofline bound
    is, over the traced control steps; None where this cell's configuration
    runs another kernel or the trace holds none of it."""
    k = run.config["kernel"]
    if k["family"] != family or run.trace is None:
        return None
    seconds = sum(v for name, v in run.trace["device_time_by_name"].items()
                  if k["name"] in name)
    if seconds <= 0:
        return None
    return 100.0 * run.trace["steps"] * control_step_bound_s(run.config) / seconds


def step_mfu(run):
    """Percent of the FP32 peak that one control step's rollout operations
    are, over the traced stretch's time per step."""
    if run.trace is None or run.trace["steps"] <= 0:
        return None
    per_step = run.trace["window_s"] / run.trace["steps"]
    return 100.0 * control_step_ops(run.config) / (per_step * PEAK_FP32_FLOPS)
