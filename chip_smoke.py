#!/usr/bin/env python3
"""Drive icem_torch's main paths on one CUDA card and hold its kernels
against their plain PyTorch versions.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``icem_torch/csrc`` (into ``build/``), then:

1. prints the card's name and power limit, the build time and nvcc's register,
   stack and spill report, and for each kernel and shape its shared memory
   per block and the warps an SM holds at once;
2. runs the planar rollout kernel against ``rollout_planar_reference`` on the
   card at every shape the HalfCheetah path launches (P = 32,921, 26,214 and
   20,971 at h = 30, and the real env step's P = 1, h = 1), on Q and QD
   passed as the env passes them, column slices of its state;
3. checks the colored-noise synthesis on the card against a float64 numpy
   synthesis of the same white draws, and the variance of a full-width draw;
4. drives the HalfCheetah path: 20 iCEM plan steps at population 32,768 and
   horizon 30 (the unrolled CEM loop), each followed by one real env step,
   counting the kernel's launches, then a few steps of ``MpcICem.get_action``
   at the settings file's own population;
5. times the planar kernel at every shape of step 2, its plain version and
   the plan step, and computes the kernel's bound from the operations and
   bytes of this run; then builds the kernels' profile variant and prints
   the cycles one trajectory's group of lanes spends in each phase group;
6. runs the spatial rollout kernel against ``rollout_spatial_reference`` at
   every shape the spatial path launches: Ant3D and HumanoidStandup3D at
   P = 4,115 (4,096 fresh rows + 19 elites, every iteration of the scanned
   CEM loop), h = 30, and P = 1, h = 1 (HumanoidStandup3D's plain version
   covers the first 10 of the 30 steps: its cost is its launch count), on
   Q and QD passed as the env passes them, column slices of its state;
7. drives the spatial path: 20 scanned-loop plan steps on Ant3D at
   population 4,096 and horizon 30, each followed by one real env step, then
   ``MpcICem.get_action`` through the registry at settings/ant's own
   parameters, then 5 plan steps on HumanoidStandup3D;
8. times the spatial kernel at both h = 30 shapes with its plain version and
   its bound, and the Ant3D plan step;
9. prints, from the same profile build, the cycles one warp of the spatial
   kernel spends in each phase group of a control step at both shapes;
10. holds both kernels against their plain versions at the shapes the
    experiment driver launches on the shipped i-cem-blitz settings, and
    times them there: the planar kernel at P = 43, 32 and 25 (h = 30), the
    spatial one at Ant's and Humanoid3D's P = 131, h = 12 and
    HumanoidStandup3D's P = 43, h = 30 (the spatial plain versions over the
    first 10 steps);
11. runs the driver, ``icem_torch.main.run``, on
    settings/halfcheetah_running/i-cem-blitz.json (1 episode of 1,000
    steps), settings/ant/i-cem-blitz.json and humanoid/i-cem-blitz.json
    (300 steps each) and settings/humanoid_standup/i-cem-blitz.json with
    task_horizon 210 (5 episodes, 2 chunks each), each as shipped otherwise
    and under a
    temporary model_dir: launches, return, ms per control step, env steps/s,
    host waits for the card, and the device idle share over a 20-step
    episode;
12. resumes a HalfCheetah run from its checkpoint, and reloads a controller
    saved on the card: its next action must be the same to the bit;
13. holds the planar kernel against its plain version at the other planar
    shapes, each env through the registry: Hopper <6, 4, 3, 3> at the
    shapes its shipped settings launch (P = 2,062 / 1,638 / 1,310 / 1,048,
    h = 30), Reacher's hinge-root arm <2, 2, 0, 2>, PlanarAnt <7, 5, 6, 4>,
    the planar humanoid <12, 10, 10, 9> (the motor speed line) and the
    swimmer <8, 6, 0, 5> (fluid drag) at P = 2,062, h = 30, and each at
    P = 1, h = 1; and times each at those shapes and at P = 32,921, h = 30,
    beside its bound;
14. runs ``MpcICem.get_action`` through the registry on Reacher, PlanarAnt,
    PlanarHumanoidStandup and the swimmer at pop 2,048, h = 30;
15. runs the driver on settings/hopper/i-cem-blitz.json (500 of its 1,000
    steps, 5 launches a step), pendulum/i-cem-blitz.json,
    mountain_car/i-cem-best.json (1 of its 3 iterations, 110 of its 200
    steps) and planet/cartpole_swingup_gt.json (action repeat 8; 1 of 2
    iterations, 5 of 125 steps), the last three analytic envs without a
    kernel, as in step 11;
16. holds both kernels against their plain versions at the shapes the other
    controllers launch: vanilla CEM as settings/halfcheetah_running/
    cem-std.json ships it (P = 97, h = 30) and random shooting at the JAX
    package's defaults (P = 40, h = 30), on HalfCheetah and Ant3D, and the
    repeated Ant3D's sub-steps (P = 64, h = 1), and times them there;
17. runs ``MpcCemStd.get_action`` and ``MpcRandom.get_action`` through the
    registry on HalfCheetah and Ant3D, and vanilla CEM on an Ant3D with
    action repeat 2 (every sub-step an h = 1 launch);
18. builds the learned models of the five learned-model settings on the
    card through the registry at the settings' widths (the ensemble
    E 5 x (200, 200, 200) on HalfCheetah and E 5 x (128, 128) on the
    pendulum, the RSSM det 200, stoch 30, hidden 200, embed 128 on dm
    cheetah, cart-pole and reacher), holds one ``apply_fn`` step at the
    planner's population and one update on an injected batch against a CPU
    copy of the same weights, then runs the driver on each setting, cut to
    1 random initial episode and 1 training iteration (HalfCheetah 100
    steps, the pendulum's 120 as shipped, the planet envs 25 control
    steps and 20 of their 100 updates a training): the model trains after
    each iteration and the planner plans with its live weights; kernel B1
    runs the planar envs' real steps;
19. runs the driver on settings/halfcheetah_running/cem-std.json (1,000
    steps), fetch_reach/i-cem-blitz.json as shipped, fpp with 25 of its 50
    steps, door and relocate/i-cem-blitz.json with 50 of their 200 steps
    (returns beside success rates), and HalfCheetah with a ``random``
    initial phase (200-step episodes), as in step 11; the host waits of
    every run are printed by source line;
20. [autodiff]: the autodiff engines (``envs/physics/planar.py``,
    ``spatial.py``) on the card, for each of the six planar shapes, Ant3D
    and HumanoidStandup3D: one control step of 4 states against the same
    code on the CPU and against kernel B1 / B2 at P = 1, h = 1 from the same
    states, and ms per step; the energy-audit battery of
    tests/test_energy_pump.py on the card for HalfCheetah and the Hopper,
    without and with the energy valve; then 20 real steps of a valve
    HalfCheetah under MpcICem (the real step on the autodiff engine, the
    planner on B1);
21. [video]: the driver on settings/halfcheetah_running/i-cem-blitz.json and
    ant/i-cem-blitz.json, 20 steps, with rollout_params.record and without:
    each AVI holds one frame per step and parses; ms per control step
    recorded and unrecorded, ms per rendered frame, seconds to write an
    episode's AVI and GIF; then one ``get_action`` with
    do_visualize_plan="record".
22. [sharded]: the sharded planner (``icem_torch/parallel``), last. One
    rank under NCCL in this process: the driver on
    settings/halfcheetah_running/i-cem-blitz.json and cem-std.json with
    controller_params.sharded=true (1,000 steps each, held as in step 11 and
    19), beside the unsharded runs' ms per control step. Then both kernels
    against their plain versions at the rows one rank of two launches
    (HalfCheetah P = 22 / 16 / 13, h = 30; Ant P = 66 / 51 / 41, h = 12),
    timed there, and two rank processes of this script
    (``--sharded-rank``) in a gloo group over a FileStore on the one card,
    each running ``MpcICem`` from the HalfCheetah and Ant i-cem-blitz
    settings with sharded=True for 2 plan steps: both ranks' actions,
    means, stds and elites must be the same bits, and the same bits as a
    one-process emulation of the sharded plan on the card.

The MpcICem phases build their controllers from the settings files as the
driver does (``icem_torch.main.get_controllers``).

Every check raises on failure, so the script exits non-zero and prints no
result. It also fails where there is no CUDA device: nothing runs on the CPU.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Full float32 matmuls: TF32 keeps about three decimal digits and would fail
# the colored-noise parity at 2e-4. Both switches are set off, and said so.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

SEED = 0


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# operation count of the plain version

# one operation per output element of each arithmetic or comparison op the
# plain version dispatches; data movement (stack, permute, select, ...) is
# counted as bytes, not here
_ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
              "sin", "cos", "clamp", "clamp_min", "clamp_max", "maximum",
              "minimum", "where", "sign", "lt", "gt", "le", "ge", "bitwise_or"}


def plain_ops_per_trajectory_step(model, device, reference=None) -> float:
    """Arithmetic operations of a rollout's plain version (by default
    ``rollout_planar_reference``) for one trajectory and one control step.
    The row engines have no data-dependent branch (every switch is a
    ``where`` or a clamp), so the count does not depend on the inputs and
    scales exactly with P * h."""
    from torch.utils._python_dispatch import TorchDispatchMode

    if reference is None:
        from icem_torch.ops.planar_rollout import rollout_planar_reference as reference

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _ARITH_OPS:
                self.ops[name] += out.numel()
            return out

    P, h = 64, 1
    nd, na = model.ndof, len(model.actuator_dof)
    Q = torch.zeros((P, nd), device=device)
    A = torch.zeros((P, h, na), device=device)
    with Counter() as counter:
        reference(model, Q, Q, A)
    return sum(counter.ops.values()) / (P * h)


def rollout_bound_ms(ops_per_traj_step: float, P: int, h: int, nd: int, na: int):
    """(bound_ms, bound_by) of one rollout: operations over the FP32 peak
    against bytes (each input read once, each output written once) over the
    HBM rate."""
    flops = ops_per_traj_step * P * h
    nbytes = 4 * (2 * nd * P + P * h * na + 2 * h * P * nd)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases

def phase_build():
    from icem_torch.ops._build import load_library

    _, info = load_library()
    log(f"[build] kernels built in {info.seconds:.2f} s -> {info.path}")
    for line in info.ptxas_log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            log(f"[build] ptxas: {line.strip()}")
    regs = re.findall(r"Used (\d+) registers", info.ptxas_log)
    check(bool(regs), "no ptxas register report in the build log")
    return info


def phase_spatial_build_report(info, models):
    """For each shape of the spatial kernel: ptxas's registers, stack and
    spills, the dynamic shared memory per block (4 warps' workspaces) and the
    warps an SM holds at once, by the occupancy calculator."""
    from icem_torch.ops._build import load_library
    from icem_torch.ops.spatial_rollout import occupancy

    lib, _ = load_library()
    for name, model in models.items():
        rep = occupancy(lib, info.ptxas_log, model)
        check(rep["warps_per_sm"] > 0, f"the spatial kernel fits no block on an SM: {rep}")
        log(f"[build] spatial kernel {name} <{rep['shape']}>: "
            f"{rep['registers']} registers, {rep['stack']} bytes stack, "
            f"{rep['spill_stores']} bytes spill stores, {rep['spill_loads']} bytes spill "
            f"loads; {rep['smem_per_block']} bytes of shared memory per block of 4 warps; "
            f"{rep['warps_per_sm']} resident warps per SM")


def main_path_config(pop: int = 32768):
    """bench.py's configuration (bench.py:76-86) over i-cem-blitz's structure."""
    from icem_torch.controllers import icem as ic

    return ic.ICemConfig(horizon=30, num_simulated_trajectories=pop,
                         factor_decrease_num=1.25, noise_beta=0.25, elites_size=pop // 64,
                         action_dim=6, action_low=(-1.0,) * 6, action_high=(1.0,) * 6)


def main_path_shapes(cfg):
    """(P, h) of every rollout launch of one plan step and its env step: the
    first CEM iteration carries the shifted elites; the real step is one
    trajectory for one control step."""
    pops = list(cfg.population_schedule)
    pops[0] += cfg.elites_kept
    return [(p, cfg.horizon) for p in pops] + [(1, 1)]


def _seeded_rollout_inputs(model, P: int, h: int, device, seed: int):
    """States near HalfCheetah's init distribution, as the env passes them:
    Q and QD are column slices of one [P, 2 nd] state tensor, rows at the
    state's stride. Uniform actions."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nd, na = model.ndof, len(model.actuator_dof)
    Q = torch.rand((P, nd), generator=gen, device=device) * 0.2 - 0.1
    QD = 0.1 * torch.randn((P, nd), generator=gen, device=device)
    A = torch.rand((P, h, na), generator=gen, device=device) * 2.0 - 1.0
    S = torch.cat([Q, QD], dim=1)
    return S[:, :nd], S[:, nd:], A


QUANTILES = [0.5, 0.9, 0.99, 0.999, 1.0]


def _quantiles(x: torch.Tensor) -> str:
    return " ".join(f"{v:.3e}" for v in np.quantile(x.cpu().numpy(), QUANTILES))


def _replay_one_step(model, Q, QD, A, qs, qds, rows, steps: int, reference=None):
    """max |dq| of each step t < ``steps`` of the trajectories ``rows``,
    with the plain version (by default ``rollout_planar_reference``) started
    from the kernel's own state at the start of step t: the kernel's
    one-step error, free of what earlier steps' roundoff did. Returns
    [len(rows), steps]."""
    if reference is None:
        from icem_torch.ops.planar_rollout import rollout_planar_reference as reference

    starts_q = torch.cat([Q[None], qs[:steps - 1]])[:, rows]     # [steps, n, nd]
    starts_qd = torch.cat([QD[None], qds[:steps - 1]])[:, rows]
    acts = A[rows, :steps].transpose(0, 1)                        # [steps, n, na]
    nd = Q.shape[1]
    rq, _ = reference(model, starts_q.reshape(-1, nd), starts_qd.reshape(-1, nd),
                      acts.reshape(-1, 1, acts.shape[-1]))
    local = (rq[0].reshape(steps, len(rows), nd) - qs[:steps, rows]).abs().amax(-1)
    return local.T


# Below this many trajectories the late window's 0.99 quantile is set by
# one or two chaotic trajectories and says nothing of the kernel; there each
# trajectory is held to the bits of the same rows inside a launch of this
# many (whose population the quantile rules measure).
EMBED_P = 1024

# Models whose dynamics turn a one-ulp change of the start state into more
# than the fixed limits below: the Hopper (gear 200 on light links, qd up to
# its 50 rad/s rail) moves q by ~1e-4 in one step and by O(1) over 30 steps
# under a one-ulp change of q, in the kernel and in the plain version alike
# (tests/test_torch_planar_envs.py). There the kernel is held to the gap that
# such a change opens in the kernel itself: the one-step errors of every
# trajectory over the first 3 steps, replayed from the kernel's own states,
# have a 0.999 quantile and a maximum within 4x of those of the first step's
# gaps under a one-ulp change of Q (per trajectory, the largest over its
# dofs); the late window's 0.99 quantile < 4x the one-ulp gap's, without
# the absolute 1e-3. Below EMBED_P trajectories the existing rules hold.
AMPLIFIES_ROUNDOFF = ("Hopper",)


def _check_embedded(rollout, model, Q, QD, A, qs, qds, big, tag: str):
    """Each trajectory of a small launch gives the bits of the same inputs
    at rows 7.. of a launch of ``EMBED_P`` rows: a trajectory's result does
    not depend on the population, on a partly filled warp or on its group's
    place in the warp. ``big``: (Q, QD, A) of EMBED_P rows, strided as the
    env passes them, whose rows 7..7+P are overwritten."""
    P = Q.shape[0]
    bq, bqd, ba = big
    bq[7:7 + P], bqd[7:7 + P], ba[7:7 + P] = Q, QD, A
    gq, gqd = rollout(model, bq, bqd, ba)
    same = torch.equal(gq[:, 7:7 + P], qs) and torch.equal(gqd[:, 7:7 + P], qds)
    log(f"[{tag}]   the {P} trajectories at rows 7..{6 + P} of a launch of {EMBED_P}: "
        f"{'the same bits' if same else 'DIFFERENT bits'} over all {qs.shape[0]} steps")
    check(same, f"{tag}: P={P} differs from the same rows of a launch of {EMBED_P}")


def phase_kernel_vs_plain(device, shapes, env=None):
    """The kernel against its plain version at every shape the main path
    launches, on HalfCheetah or on ``env``'s model.

    First 3 control steps: |dq| < 1e-4 for every trajectory (the repo's
    tolerance is 1e-3), except where a discrete switch of the model turns
    roundoff into a jump. A penalty contact switches on (with its damping
    term) when a geom's height crosses 0, and limit damping when q crosses a
    joint limit; a trajectory that meets a crossing within roundoff diverges
    there. Each such trajectory is replayed one step at a time from the
    kernel's own states and must then agree to 1e-4 at every step.

    Last 10 steps: the dynamics amplify roundoff, so the gap is held to
    what a one-ulp change of the start state does to the kernel itself: the
    0.99 quantile of |dq| under 1e-3 and within 4x of the one-ulp gap's.
    Below EMBED_P trajectories the 4x is not held (one chaotic trajectory
    sets the quantile); there every trajectory must give the bits of the
    same inputs inside a launch of EMBED_P rows (``_check_embedded``).
    A model of AMPLIFIES_ROUNDOFF is held by the rules given there.

    Returns (the largest error checked over the first 3 steps of every
    shape, a diverged trajectory counting with its one-step errors; the
    plain version's ms at the first shape)."""
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops.planar_rollout import rollout_planar, rollout_planar_reference

    env = HalfCheetah() if env is None else env
    model, name = env.model, env.name
    amplifies = name in AMPLIFIES_ROUNDOFF
    worst, plain_ms = 0.0, None
    for k, (P, h) in enumerate(shapes):
        Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED + k)
        qs, qds = rollout_planar(model, Q, QD, A)
        # the rows at the state's stride, as the env passes them, against
        # contiguous copies: the same reads, so the same bits
        qs_c, qds_c = rollout_planar(model, Q.contiguous(), QD.contiguous(), A)
        check(Q.stride(0) > model.ndof and QD.stride(0) > model.ndof,
              "the compared inputs are not strided rows")
        check(torch.equal(qs, qs_c) and torch.equal(qds, qds_c),
              f"{name}: the kernel reads strided rows differently from contiguous ones, P={P}")
        log(f"[kernel] {name} P={P} h={h}: rows at stride {Q.stride(0)} give the same "
            f"bits as contiguous rows")
        Q_ulp = torch.nextafter(Q, torch.full_like(Q, float("inf")))
        qs_ulp, _ = rollout_planar(model, Q_ulp, QD, A)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        rq, rqd = rollout_planar_reference(model, Q, QD, A)
        stop.record()
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = start.elapsed_time(stop)
        check(tuple(qs.shape) == tuple(qds.shape) == (h, P, model.ndof),
              f"{name}: kernel output shape {tuple(qs.shape)}")
        check(bool(torch.isfinite(qs).all() and torch.isfinite(qds).all()
                   and torch.isfinite(qs_ulp).all()), f"{name}: non-finite kernel output at P={P}")
        check(bool(torch.isfinite(rq).all() and torch.isfinite(rqd).all()),
              f"{name}: non-finite plain-version output at P={P}")
        dq = (qs - rq).abs()
        first = min(h, 3)
        per_traj = dq[:first].amax(dim=(0, 2))                       # [P]
        diverged = torch.nonzero(per_traj >= 1e-4).flatten()
        same = int(((qs == rq).all(dim=2).all(dim=0) & (qds == rqd).all(dim=2).all(dim=0)).sum())
        log(f"[kernel] {name} P={P} h={h}: max |dq| over the first {first} control "
            f"steps = {float(per_traj.max()):.3e}; {len(diverged)} of {P} trajectories "
            f"at 1e-4 or more; {same} of {P} bit-identical to the plain version over all "
            f"{h} steps")
        checked = per_traj.masked_fill(per_traj >= 1e-4, 0.0).max()
        # (below EMBED_P trajectories the quantiles say nothing: the
        # existing rules hold there)
        if amplifies and P >= EMBED_P:
            # every trajectory's one-step errors, against the one-step gap a
            # one-ulp change of Q opens in the kernel
            local = _replay_one_step(model, Q, QD, A, qs, qds, torch.arange(P, device=device),
                                     first)
            ulp1 = (qs_ulp[0] - qs[0]).abs().amax(-1)                     # [P]
            q999 = float(np.quantile(local.cpu().numpy(), 0.999))
            u999 = float(np.quantile(ulp1.cpu().numpy(), 0.999))
            log(f"[kernel]   {name} amplifies roundoff: one-step errors of all {P} trajectories "
                f"over {first} steps from the kernel's own states: quantiles {QUANTILES}: "
                f"{_quantiles(local)}; the kernel's first-step gaps under a one-ulp change of "
                f"Q: {_quantiles(ulp1)} (0.999 quantile and maximum: limit 4x)")
            check(q999 < 4 * u999 and float(local.max()) < 4 * float(ulp1.max()),
                  f"{name}: one-step errors at P={P}: 0.999 quantile {q999:.3e}, max "
                  f"{float(local.max()):.3e}; one-ulp gaps {u999:.3e}, {float(ulp1.max()):.3e}")
            checked = torch.maximum(checked, local.max())
        elif len(diverged):
            local = _replay_one_step(model, Q, QD, A, qs, qds, diverged, first)
            for p, row in list(zip(diverged.tolist(), local.tolist()))[:8]:
                t = int(dq[:first, p].amax(-1).gt(1e-5).nonzero()[0])
                log(f"[kernel]   trajectory {p} diverges in step {t + 1}: max |dq| "
                    f"{float(per_traj[p]):.3e}; one-step error from the kernel's own "
                    f"states, per step: " + " ".join(f"{v:.2e}" for v in row))
            log(f"[kernel]   largest one-step error of the {len(diverged)} replayed: "
                f"{float(local.max()):.3e}")
            check(float(local.max()) < 1e-4,
                  f"{name}: kernel's one-step error {float(local.max()):.3e} >= 1e-4 at P={P}")
            checked = torch.maximum(checked, local.max())
        worst = max(worst, float(checked))
        limit = "4x the one-ulp gaps" if amplifies and P >= EMBED_P else "1e-4"
        log(f"[kernel]   largest error checked: {float(checked):.3e} (limit {limit})")
        if P < EMBED_P:
            _check_embedded(rollout_planar, model, Q, QD, A, qs, qds,
                            _seeded_rollout_inputs(model, EMBED_P, h, device, SEED + 50 + k),
                            "kernel")
        if h < 20:
            continue
        log(f"[kernel]   |dq|  quantiles {QUANTILES} over all {h} steps: {_quantiles(dq)}")
        log(f"[kernel]   |dqd| quantiles {QUANTILES} over all {h} steps: "
            f"{_quantiles((qds - rqd).abs())}")
        log("[kernel]   max |dq| per control step: "
            + " ".join(f"{t + 1}:{v:.1e}" for t, v in enumerate(dq.amax(dim=(1, 2)).tolist())))
        late, late_ulp = dq[h - 10:], (qs - qs_ulp).abs()[h - 10:]
        log(f"[kernel]   steps {h - 9}-{h}: |dq| quantiles {_quantiles(late)}; kernel with Q "
            f"moved one ulp vs kernel: {_quantiles(late_ulp)}")
        q99 = float(np.quantile(late.cpu().numpy(), 0.99))
        q99_ulp = float(np.quantile(late_ulp.cpu().numpy(), 0.99))
        ratio_rule = P >= EMBED_P
        relative_only = amplifies and ratio_rule
        log(f"[kernel]   steps {h - 9}-{h}: 0.99 quantile of |dq| {q99:.3e} "
            f"({'no absolute limit: ' + name + ' amplifies roundoff' if relative_only else 'limit 1e-3'}"
            f"), {q99 / q99_ulp:.3f}x the one-ulp gap's {q99_ulp:.3e} "
            f"({'limit 4x' if ratio_rule else 'not held below ' + str(EMBED_P) + ' trajectories'})")
        check((q99 < 1e-3 or relative_only) and (q99 < 4 * q99_ulp or not ratio_rule),
              f"{name}: late-horizon gap at P={P}: 0.99 quantile {q99:.3e}, one-ulp "
              f"{q99_ulp:.3e}")
    return worst, plain_ms


def _numpy_powerlaw(white_real, white_imag, beta, n):
    """float64 synthesis of the power-law spectrum (the published algorithm
    of the colorednoise package) from given white draws."""
    f = np.fft.rfftfreq(n)
    s_scale = np.array(f)
    ix = int(np.sum(s_scale < 1.0 / n))
    if ix and ix < len(s_scale):
        s_scale[:ix] = s_scale[ix]
    s_scale = s_scale ** (-beta / 2.0)
    w = s_scale[1:].copy()
    w[-1] *= (1 + (n % 2)) / 2.0
    sigma = 2 * np.sqrt(np.sum(w**2)) / n
    sr = white_real * s_scale
    si = white_imag * s_scale
    if not n % 2:
        si[..., -1] = 0
        sr[..., -1] *= np.sqrt(2)
    si[..., 0] = 0
    sr[..., 0] *= np.sqrt(2)
    return np.fft.irfft(sr + 1j * si, n=n, axis=-1) / sigma


def phase_colored_noise(device):
    from icem_torch.ops.colored_noise import sample_colored_action_noise, shape_white_spectrum

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for n in (30, 31):
        for beta in (0.25, 1.0, 2.5):
            shape = (64, 6, n // 2 + 1)
            wr = rng.standard_normal(shape).astype(np.float32)
            wi = rng.standard_normal(shape).astype(np.float32)
            got = shape_white_spectrum(torch.from_numpy(wr).to(device),
                                       torch.from_numpy(wi).to(device), beta, n).cpu().numpy()
            want = _numpy_powerlaw(wr.astype(np.float64), wi.astype(np.float64), beta, n)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
            worst = max(worst, float(np.abs(got - want).max()))
    log(f"[noise] shape_white_spectrum on the card vs float64 numpy: max |d| = {worst:.3e} "
        f"(limit 2e-4 + 2e-4 * |ref|)")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    y = sample_colored_action_noise(gen, 0.25, 32768, 30, 6)
    check(tuple(y.shape) == (32768, 30, 6), f"noise shape {tuple(y.shape)}")
    std = float(y.std())
    std_ac = float((y - y.mean(dim=1, keepdim=True)).std())
    log(f"[noise] [32768, 30, 6] beta=0.25: std {std:.4f}, std after removing each "
        f"series' mean {std_ac:.4f}")
    # the package's normalisation gives the AC part unit std; the boosted DC
    # bin lifts the total a few percent (tests/test_colored_noise.py)
    check(abs(std_ac - 1.0) < 0.02, f"AC std {std_ac} not within 2% of 1")
    check(abs(std - 1.0) < 0.05, f"total std {std} not within 5% of 1")


def profile_window(fn, steps: int, tag: str):
    """Where ``steps`` control steps' time goes: ``fn()`` runs them under
    torch.profiler; prints the wall time per step, the device time by kernel
    and the device's idle share (the profiler's own overhead lengthens the
    host side). Returns the idle share, or None where the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = lambda e: e.self_device_time_total
    rows = sorted((e for e in kernels if device_us(e) > 0), key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / steps
    if busy_ms == 0:
        log(f"[{tag}] the profiler saw no device time: device idle share not measured")
        return None
    idle = 1 - busy_ms / wall_ms
    log(f"[{tag}] per control step under the profiler, {steps} steps: wall {wall_ms:.3f} ms, "
        f"kernels {busy_ms:.3f} ms, device idle share {idle:.3f}")
    for e in rows[:8]:
        log(f"[{tag}]   {device_us(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d} "
            f"calls/step  {e.key[:90]}")
    return idle


def profile_plan_steps(cfg, model, env, pstate, state, obs, steps: int, tag: str = "profile"):
    """profile_window over a few steady plan steps, each with its env step."""
    from icem_torch.controllers import icem as ic

    def run():
        nonlocal pstate, state, obs
        for _ in range(steps):
            res = ic.plan_step(cfg, model.predict_fn, env.cost_fn, pstate, obs, state)
            pstate = res.state
            state, obs, _, _ = env.step(state, res.action)

    profile_window(run, steps, tag)


def settings_controller(name: str, device, *overrides):
    """(env, controller) of ``settings/<name>.json`` with overrides,
    built as the driver builds them (``icem_torch.main.get_controllers``)."""
    from icem_torch.envs import env_from_string
    from icem_torch.main import get_controllers
    from icem_torch.models import forward_model_from_string
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    params = apply_overrides(resolve_settings(f"settings/{name}.json"), list(overrides))
    env = env_from_string(params.env, **params.get("env_params", {}))
    model = forward_model_from_string(params.forward_model)(
        env=env, **params.get("forward_model_params", {}))
    return env, get_controllers(params, env, model, device)[1]


def phase_main_path(device, cfg, plan_steps: int):
    from icem_torch.controllers import icem as ic
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.ops import planar_rollout

    env = HalfCheetah(exclude_current_positions_from_observation=True,
                      penalise_flipping=True)
    model = GroundTruthModel(env=env)
    pop = cfg.num_simulated_trajectories
    traj_per_step = sum(cfg.population_schedule) + cfg.elites_kept
    log(f"[main] HalfCheetah iCEM pop {pop} h {cfg.horizon}: populations "
        f"{cfg.population_schedule} + {cfg.elites_kept} shifted elites = "
        f"{traj_per_step} rollouts per plan step")

    env_gen = torch.Generator(device=device)
    env_gen.manual_seed(SEED)
    plan_gen = torch.Generator(device=device)
    plan_gen.manual_seed(SEED + 1)
    state = env.init_state(env_gen)
    obs = env.observation(state)
    pstate = ic.init_state(cfg, env.obs_dim, plan_gen)

    rewards, costs, step_ms, launches = [], [], [], []
    planar_rollout.LAUNCHES = 0
    for _ in range(plan_steps):
        before = planar_rollout.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ic.plan_step(cfg, model.predict_fn, env.cost_fn, pstate, obs, state)
        pstate = res.state
        state, obs, rew, _ = env.step(state, res.action)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(planar_rollout.LAUNCHES - before)
        rewards.append(rew)
        costs.append(res.expected_cost)
    main_launches = planar_rollout.LAUNCHES

    rewards = torch.stack(rewards).cpu().numpy()
    costs = torch.stack(costs).cpu().numpy()
    log(f"[main] launches per plan step + env step: {launches}")
    log(f"[main] rewards: {np.array2string(rewards, precision=3, max_line_width=200)}")
    log(f"[main] expected costs: {np.array2string(costs, precision=2, max_line_width=200)}")
    check(all(n == 4 for n in launches), f"expected 4 launches per step, got {launches}")
    check(main_launches == 4 * plan_steps, f"{main_launches} launches in the main path")
    check(bool(np.all(np.isfinite(costs))), "non-finite planning costs")
    check(bool(np.all(np.isfinite(rewards))), "non-finite rewards")
    late = float(np.mean(rewards[-10:]))
    log(f"[main] mean reward of the last 10 steps: {late:.4f} (must be > 0)")
    check(late > 0.0, "the cheetah does not run forward")

    # steady state: the first step carries one-time set-up (cuBLAS, caches)
    steady = np.array(step_ms[1:])
    plan_ms = float(np.median(steady))
    log(f"[main] plan step + env step, host clock after synchronize, steps 2..{plan_steps}: "
        f"median {plan_ms:.3f} ms, min {steady.min():.3f}, max {steady.max():.3f}; "
        f"{traj_per_step / (plan_ms / 1e3):.1f} rollouts/s")

    profile_plan_steps(cfg, model, env, pstate, state, obs, steps=3)

    # the controller API at the settings file's own population, built from
    # the resolved settings as the driver builds it
    ctrl_env, ctrl = settings_controller("halfcheetah_running/i-cem-blitz", device,
                                            f"controller_params.seed={SEED + 2}")
    check(ctrl.cfg.num_simulated_trajectories == 40 and ctrl.cfg.noise_beta == 0.25
          and ctrl.cfg.cem_loop == "unrolled", f"HalfCheetah settings resolved to {ctrl.cfg}")
    s = ctrl_env.init_state(env_gen)
    o = ctrl_env.observation(s)
    ctrl.beginning_of_rollout(observation=o, state=s)
    before = planar_rollout.LAUNCHES
    for _ in range(5):
        a = ctrl.get_action(o, s)
        check(a.shape == (6,) and bool(np.all(np.abs(a) <= 1.0)), f"bad action {a}")
        s, o, _, _ = ctrl_env.step(s, torch.as_tensor(a, device=device))
    check(planar_rollout.LAUNCHES - before == 5 * 4,
          f"MpcICem: {planar_rollout.LAUNCHES - before} launches in 5 steps")
    check(bool(torch.isfinite(s).all()), "MpcICem episode state is not finite")
    log(f"[main] MpcICem.get_action from settings/halfcheetah_running/i-cem-blitz.json "
        f"(pop 40): 5 steps, 4 launches each, last expected cost "
        f"{float(ctrl.last_expected_cost):.3f}")
    return dict(launches=main_launches, plan_ms=plan_ms, traj_per_step=traj_per_step,
                late_reward=late)


def phase_times(device, shapes, plain_ms: float):
    """ms per launch of the planar kernel at every shape of a plan step and
    its env step, on strided rows as the env passes them; the bound and the
    plain version at the first (largest) shape."""
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops.planar_rollout import rollout_planar

    model = HalfCheetah().model
    per_shape = []
    for P, h in shapes:
        Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED)
        reps = 20 if h > 1 else 50
        ms = cuda_ms(lambda: rollout_planar(model, Q, QD, A), reps=reps, warmup=2)
        per_shape.append(ms)
        log(f"[times] rollout kernel, HalfCheetah P={P} h={h}: {ms:.4f} ms per launch, "
            f"CUDA events over {reps} launches")
    planner = sum(per_shape[:-1])
    log(f"[times] the plan step's {len(shapes) - 1} planner launches: {planner:.4f} ms in all; "
        f"with the env step's launch {planner + per_shape[-1]:.4f} ms")
    P, h = shapes[0]
    kernel_ms = per_shape[0]
    ops = plain_ops_per_trajectory_step(model, device)
    bound_ms, bound_by = rollout_bound_ms(ops, P, h, model.ndof, len(model.actuator_dof))
    log(f"[times] plain version at P={P} h={h} and the same inputs: {plain_ms:.1f} ms "
        f"(one call, in the comparison above)")
    log(f"[times] plain version's operations: {ops:.1f} per trajectory-step, "
        f"{ops * P * h / 1e9:.3f} G per launch; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32, {PEAK_HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
        f"kernel at {bound_ms / kernel_ms * 100:.1f}% of its bound")
    log("[times] library_ms: none; no single PyTorch call computes a planar rollout")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                ops=ops, P=P, planner_ms=planner)


def phase_planar_build_report(info, models):
    """The planar kernel's resources at each shape (``models``: name ->
    model): ptxas's registers, stack and spills, the lanes per trajectory,
    the dynamic shared memory per block (its groups' workspaces) and the
    warps an SM holds at once."""
    from icem_torch.ops._build import load_library
    from icem_torch.ops.planar_rollout import occupancy

    for name, model in models.items():
        rep = occupancy(load_library()[0], info.ptxas_log, model)
        check(rep["warps_per_sm"] > 0, f"the planar kernel fits no block on an SM: {rep}")
        log(f"[build] planar kernel {name} <{rep['shape']}>: {rep['registers']} registers, "
            f"{rep['stack']} bytes stack, {rep['spill_stores']} bytes spill stores, "
            f"{rep['spill_loads']} bytes spill loads; {rep['lanes']} lanes per trajectory; "
            f"{rep['smem_per_block']} bytes of shared memory per block of 4 warps; "
            f"{rep['warps_per_sm']} resident warps per SM")


# csrc/planar_step.cuh::PlanarProfGroup, in order
PLANAR_PROFILE_GROUPS = ("io", "step_fk", "mass_rows", "cholesky", "sub_fk", "contact", "rhs",
                         "solve")
# one build of the kernels with the marks of both
PROFILE_DEFINES = ("-DICEM_SPATIAL_PROFILE", "-DICEM_PLANAR_PROFILE")


def phase_planar_profile(device, shapes):
    """Where a group's cycles go inside the planar kernel: the profile build
    (the port's kernel plus marks at which lane 0 of each group charges the
    clock64() cycles since the last mark to the phase group that just
    ended), launched at the plan step's first shape; trajectory 0's group
    over the last launch. These launches count nothing."""
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops import _build
    from icem_torch.ops import planar_rollout as pr

    info = _build.build(PROFILE_DEFINES)
    lib = ctypes.CDLL(str(info.path))
    read = lib.planar_profile_read
    read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
    model = HalfCheetah().model
    P, h = shapes[0]
    Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED)
    kernel = pr.bind(lib, model)
    ms = cuda_ms(lambda: pr.launch_bound(kernel, Q, QD, A), reps=3)
    rep = pr.occupancy(lib, info.ptxas_log, model)
    cycles = (ctypes.c_longlong * len(PLANAR_PROFILE_GROUPS))()
    check(read(cycles) == len(PLANAR_PROFILE_GROUPS), "planar_profile_read failed")
    total = sum(cycles)
    check(total > 0 and min(cycles) >= 0, f"bad planar profile {list(cycles)}")
    per_substep = total / (h * model.n_substeps)
    log(f"[profile] planar kernel HalfCheetah, profile build ({rep['registers']} registers, "
        f"{rep['warps_per_sm']} warps per SM): {ms:.4f} ms per launch at P={P} h={h}; "
        f"trajectory 0's group, {total} cycles over {h} steps ({per_substep:.0f} per "
        f"substep): " + ", ".join(f"{g} {100.0 * c / total:.2f} %" for g, c in
                                   sorted(zip(PLANAR_PROFILE_GROUPS, cycles), key=lambda x: -x[1])))


# ---------------------------------------------------------------------------
# the other planar envs: kernel B1 at their shapes

# registry name and constructor arguments of one env per other planar shape
PLANAR_ENVS = (
    ("Hopper", dict(exclude_current_positions_from_observation=False)),
    ("Reacher", {}),
    ("PlanarAnt", dict(exclude_current_positions_from_observation=False)),
    ("PlanarHumanoidStandup", {}),
    ("swimmer", {}),
)
# the population and horizon of the planar envs without shipped settings
OTHER_PLANAR_SHAPE = (2062, 30)
THROUGHPUT_SHAPE = (32921, 30)


def planar_envs():
    from icem_torch.envs import env_from_string

    return [env_from_string(name, **kw) for name, kw in PLANAR_ENVS]


def planar_env_shapes(device, env):
    """(P, h) of the launches to hold ``env``'s kernel at: the Hopper's are
    those of its shipped settings' plan step and env step, the others' the
    Hopper's first launch and the env step."""
    if env.name == "Hopper":
        return main_path_shapes(settings_controller("hopper/i-cem-blitz", device)[1].cfg)
    return [OTHER_PLANAR_SHAPE, (1, 1)]


def phase_planar_env_times(device, env, shapes, plain_ms: float):
    """ms per launch of the planar kernel on ``env``'s model at each of
    ``shapes`` and at THROUGHPUT_SHAPE, each beside its bound; the plain
    version's ms at the first shape."""
    from icem_torch.ops.planar_rollout import kernel_shape, rollout_planar

    model, name = env.model, env.name
    ops = plain_ops_per_trajectory_step(model, device)
    nd, na = model.ndof, len(model.actuator_dof)
    out = []
    for P, h in [*shapes, THROUGHPUT_SHAPE]:
        Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED)
        reps = 20 if h > 1 else 50
        ms = cuda_ms(lambda: rollout_planar(model, Q, QD, A), reps=reps, warmup=2)
        bound_ms, bound_by = rollout_bound_ms(ops, P, h, nd, na)
        out.append(dict(P=P, h=h, ms=ms, bound_ms=bound_ms, bound_by=bound_by))
        log(f"[times] planar kernel, {name} <{', '.join(map(str, kernel_shape(model)))}> P={P} "
            f"h={h}: {ms:.4f} ms per launch, CUDA events over {reps} launches; bound "
            f"{bound_ms:.4g} ms ({bound_by}; {ops:.1f} operations per trajectory-step), kernel "
            f"at {bound_ms / ms * 100:.3g}% of its bound")
    P, h = shapes[0]
    log(f"[times]   plain version, {name} P={P} h={h}: {plain_ms:.1f} ms (one call, in the "
        f"comparison above); library_ms: none")
    return out


def phase_planar_envs(device):
    """Phases 13: every other planar shape against its plain version, and
    its times. Returns the largest error checked."""
    worst = 0.0
    for env in planar_envs():
        shapes = planar_env_shapes(device, env)
        err, plain_ms = phase_kernel_vs_plain(device, shapes, env)
        worst = max(worst, err)
        phase_planar_env_times(device, env, shapes, plain_ms)
    return worst


def phase_planar_controllers(device, pop: int = 2048, steps: int = 5):
    """``MpcICem.get_action`` through the registry on the planar envs
    without shipped ground-truth settings, at i-cem-blitz's structure, pop
    2,048 and h 30 (the unrolled loop): finite actions in the bounds, and
    the planner's iterations plus the real step in launches per step."""
    from icem_torch.controllers.icem import MpcICem
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.ops import planar_rollout
    from icem_torch.runtime.config import resolve_settings

    blitz = resolve_settings("settings/defaults/i-cem-blitz.json").controller_params
    for env in planar_envs()[1:]:
        ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=30,
                       num_simulated_trajectories=pop, seed=SEED + 7, device=device,
                       action_sampler_params=dict(blitz.action_sampler_params),
                       factor_decrease_num=blitz.factor_decrease_num)
        check(ctrl.cfg.cem_loop == "unrolled", f"{env.name}: loop {ctrl.cfg.cem_loop}")
        per_step = ctrl.cfg.opt_iterations + 1
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 8)
        s = env.init_state(gen)
        o = env.observation(s)
        ctrl.beginning_of_rollout(observation=o, state=s)
        launches, t0 = [], time.perf_counter()
        for _ in range(steps):
            before = planar_rollout.LAUNCHES
            a = ctrl.get_action(o, s)
            check(a.shape == (env.action_dim,) and bool(np.all(np.isfinite(a)))
                  and bool(np.all(np.abs(a) <= 1.0)), f"{env.name}: bad action {a}")
            s, o, _, _ = env.step(s, torch.as_tensor(a, device=device))
            launches.append(planar_rollout.LAUNCHES - before)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        check(all(n == per_step for n in launches),
              f"{env.name}: launches per step {launches}, expected {per_step}")
        check(bool(torch.isfinite(s).all()), f"{env.name}: MpcICem episode state is not finite")
        log(f"[planar] MpcICem.get_action on {env.name} through the registry, pop {pop} h 30 "
            f"unrolled: {steps} steps, launches per step {launches} ({per_step - 1} iterations "
            f"+ the real step), {ms:.1f} ms per step with the first; last expected cost "
            f"{float(ctrl.last_expected_cost):.3f}")


# ---------------------------------------------------------------------------
# the spatial (3D) path: kernel B2 and the scanned CEM loop

def spatial_path_config(action_dim: int, pop: int = 4096):
    """scripts/bench_spatial.py's configuration (bench_spatial.py:42-51):
    the repo's 3D throughput point, with the scanned CEM loop."""
    from icem_torch.controllers import icem as ic

    return ic.ICemConfig(horizon=30, num_simulated_trajectories=pop,
                         factor_decrease_num=1.25, noise_beta=1.0,
                         elites_size=max(10, pop // 64), cem_loop="scan",
                         action_dim=action_dim, action_low=(-1.0,) * action_dim,
                         action_high=(1.0,) * action_dim)


def _spatial_rollout_inputs(env, P: int, h: int, device, seed: int):
    """States near the env's start distribution, as the env passes them:
    Q and QD are column slices of one [P, state width] tensor, rows at the
    state's stride. Uniform actions."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = env.model
    nd, na = model.ndof, len(model.actuator_dof)
    S = torch.stack([env.init_state(gen) for _ in range(8)])
    S = S[torch.arange(P, device=device) % 8]
    S[:, :nd] += 0.05 * torch.randn((P, nd), generator=gen, device=device)
    S[:, nd:2 * nd] += 0.1 * torch.randn((P, nd), generator=gen, device=device)
    A = torch.rand((P, h, na), generator=gen, device=device) * 2.0 - 1.0
    return S[:, :nd], S[:, nd:2 * nd], A


def phase_spatial_kernel_vs_plain(device, cases):
    """The spatial kernel against its plain version at every shape the
    spatial path launches. ``cases``: (env, P, h, compared steps).

    Per trajectory, over the first 3 control steps: |dq| < 1e-4, or its
    one-step errors, replayed from the kernel's own states, < 1e-4 (B1's
    rule). The JAX package's spatial bulk rule over 3 steps: the 0.999
    quantile of |dq| < 1e-3 and the maximum < 5e-2. Over every compared
    step of every trajectory, the one-step errors from the kernel's own
    states: their 0.999 quantile < 1e-4 (a step that meets a contact or
    limit switch within roundoff diverges even from a shared start state, so
    the largest is printed, not held). Over the last 10 compared steps the
    0.99 quantile of |dq| < 1e-3 and < 4x the gap that a one-ulp change of
    the start state opens in the kernel itself; below EMBED_P trajectories
    the 4x is not held, and every trajectory must give the bits of the same
    inputs inside a launch of EMBED_P rows, as for the planar kernel.

    Returns (largest error checked over the first 3 steps, per env name the
    plain version's ms and the steps it covered at the first h = 30 shape)."""
    from icem_torch.ops.spatial_rollout import rollout_spatial, rollout_spatial_reference

    worst, plain = 0.0, {}
    for k, (env, P, h, steps) in enumerate(cases):
        model, name = env.model, env.name
        Q, QD, A = _spatial_rollout_inputs(env, P, h, device, SEED + 10 + k)
        qs, qds = rollout_spatial(model, Q, QD, A)
        # the rows at the state's stride, as the env passes them, against
        # contiguous copies: the same reads, so the same bits
        qs_c, qds_c = rollout_spatial(model, Q.contiguous(), QD.contiguous(), A)
        check(Q.stride(0) > model.ndof and QD.stride(0) > model.ndof,
              f"{name}: the compared inputs are not strided rows")
        check(torch.equal(qs, qs_c) and torch.equal(qds, qds_c),
              f"{name}: the kernel reads strided rows differently from contiguous ones, P={P}")
        log(f"[spatial] {name} P={P} h={h}: rows at stride {Q.stride(0)} give the same bits "
            f"as contiguous rows")
        Q_ulp = torch.nextafter(Q, torch.full_like(Q, float("inf")))
        qs_ulp, _ = rollout_spatial(model, Q_ulp, QD, A)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        rq, rqd = rollout_spatial_reference(model, Q, QD, A[:, :steps])
        stop.record()
        torch.cuda.synchronize()
        if h >= 20 and name not in plain:
            plain[name] = (start.elapsed_time(stop), steps)
        check(tuple(qs.shape) == tuple(qds.shape) == (h, P, model.ndof),
              f"{name} kernel output shape {tuple(qs.shape)}")
        check(bool(torch.isfinite(qs).all() and torch.isfinite(qds).all()
                   and torch.isfinite(qs_ulp).all()), f"non-finite {name} kernel output at P={P}")
        check(bool(torch.isfinite(rq).all() and torch.isfinite(rqd).all()),
              f"non-finite {name} plain-version output at P={P}")
        dq = (qs[:steps] - rq).abs()
        first = min(steps, 3)
        per_traj = dq[:first].amax(dim=(0, 2))
        diverged = per_traj >= 1e-4
        note = "" if steps == h else f" (the plain version covers the first {steps} of {h})"
        log(f"[spatial] {name} P={P} h={h}{note}: max |dq| over the first {first} control "
            f"steps = {float(per_traj.max()):.3e}; {int(diverged.sum())} of {P} trajectories "
            f"at 1e-4 or more")
        local = _replay_one_step(model, Q, QD, A, qs, qds, torch.arange(P, device=device),
                                 steps, rollout_spatial_reference)          # [P, steps]
        checked = per_traj.masked_fill(diverged, 0.0).max()
        if bool(diverged.any()):
            bad = local[diverged, :first]
            for p, row in list(zip(torch.nonzero(diverged).flatten().tolist(),
                                   bad.tolist()))[:8]:
                log(f"[spatial]   trajectory {p}: max |dq| {float(per_traj[p]):.3e}; one-step "
                    f"errors from the kernel's own states: " + " ".join(f"{v:.2e}" for v in row))
            check(float(bad.max()) < 1e-4,
                  f"{name}: one-step error {float(bad.max()):.3e} >= 1e-4 at P={P}")
            checked = torch.maximum(checked, bad.max())
        worst = max(worst, float(checked))
        log(f"[spatial]   largest error checked over {first} steps: {float(checked):.3e} "
            f"(limit 1e-4)")
        flat = dq[:first].flatten()
        q999 = float(np.quantile(flat.cpu().numpy(), 0.999))
        log(f"[spatial]   bulk over {first} steps: 0.999 quantile {q999:.3e} (limit 1e-3), "
            f"max {float(flat.max()):.3e} (limit 5e-2)")
        check(q999 < 1e-3 and float(flat.max()) < 5e-2, f"{name}: bulk rule at P={P}")
        q999_local = float(np.quantile(local.cpu().numpy(), 0.999))
        log(f"[spatial]   one-step errors of all {P} trajectories over {steps} steps from the "
            f"kernel's own states: quantiles {QUANTILES}: {_quantiles(local)}; "
            f"{int((local >= 1e-4).sum())} of {local.numel()} at 1e-4 or more")
        check(q999_local < 1e-4,
              f"{name}: 0.999 quantile of one-step errors {q999_local:.3e} >= 1e-4 at P={P}")
        if P < EMBED_P:
            _check_embedded(rollout_spatial, model, Q, QD, A, qs, qds,
                            _spatial_rollout_inputs(env, EMBED_P, h, device, SEED + 60 + k),
                            "spatial")
        if steps < 10:
            continue
        log("[spatial]   max |dq| per control step: "
            + " ".join(f"{t + 1}:{v:.1e}" for t, v in enumerate(dq.amax(dim=(1, 2)).tolist())))
        late = dq[steps - 10:]
        late_ulp = (qs - qs_ulp).abs()[steps - 10: steps]
        q99 = float(np.quantile(late.cpu().numpy(), 0.99))
        q99_ulp = float(np.quantile(late_ulp.cpu().numpy(), 0.99))
        ratio_rule = P >= EMBED_P
        log(f"[spatial]   steps {steps - 9}-{steps}: 0.99 quantile of |dq| {q99:.3e} (limit "
            f"1e-3), {q99 / q99_ulp:.3f}x the one-ulp gap's {q99_ulp:.3e} "
            f"({'limit 4x' if ratio_rule else 'not held below ' + str(EMBED_P) + ' trajectories'})")
        check(q99 < 1e-3 and (q99 < 4 * q99_ulp or not ratio_rule),
              f"{name}: late-window gap at P={P}: 0.99 quantile {q99:.3e}, one-ulp {q99_ulp:.3e}")
    return worst, plain


def phase_spatial_main_path(device, plan_steps: int):
    """Ant3D at bench_spatial's configuration: ``plan_steps`` scanned-loop
    plan steps, each followed by one real env step; 3 + 1 launches each."""
    from icem_torch.controllers import icem as ic
    from icem_torch.envs.ant3d import Ant3D
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.ops import spatial_rollout

    env = Ant3D(exclude_current_positions_from_observation=False)
    model = GroundTruthModel(env=env)
    cfg = spatial_path_config(env.action_dim)
    rollouts = sum(cfg.population_schedule) + cfg.elites_kept
    simulated = cfg.opt_iterations * (cfg.num_simulated_trajectories + cfg.elites_kept)
    log(f"[ant] Ant3D iCEM pop {cfg.num_simulated_trajectories} h {cfg.horizon}, scanned loop: "
        f"populations {cfg.population_schedule} + {cfg.elites_kept} elites = {rollouts} "
        f"rollouts per plan step (bench_spatial's count); {simulated} simulated rows")

    env_gen = torch.Generator(device=device)
    env_gen.manual_seed(SEED)
    plan_gen = torch.Generator(device=device)
    plan_gen.manual_seed(SEED + 1)
    state = env.init_state(env_gen)
    obs = env.observation(state)
    pstate = ic.init_state(cfg, env.obs_dim, plan_gen)
    x0 = float(state[0])

    rewards, heights, step_ms, launches = [], [], [], []
    spatial_rollout.LAUNCHES = 0
    for _ in range(plan_steps):
        before = spatial_rollout.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ic.plan_step(cfg, model.predict_fn, env.cost_fn, pstate, obs, state)
        pstate = res.state
        state, obs, rew, _ = env.step(state, res.action)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(spatial_rollout.LAUNCHES - before)
        rewards.append(rew)
        heights.append(state[2])
    main_launches = spatial_rollout.LAUNCHES

    rewards = torch.stack(rewards).cpu().numpy()
    heights = torch.stack(heights).cpu().numpy()
    x_end = float(state[0])
    log(f"[ant] launches per plan step + env step: {launches}")
    log(f"[ant] rewards: {np.array2string(rewards, precision=3, max_line_width=200)}")
    log(f"[ant] torso heights: {np.array2string(heights, precision=3, max_line_width=200)}")
    log(f"[ant] x from {x0:.4f} to {x_end:.4f} over {plan_steps} steps")
    check(all(n == 4 for n in launches), f"expected 4 launches per step, got {launches}")
    check(main_launches == 4 * plan_steps, f"{main_launches} launches in the Ant3D path")
    check(bool(torch.isfinite(state).all()) and bool(np.all(np.isfinite(rewards))),
          "non-finite Ant3D state or rewards")
    check(bool(np.all((heights > 0.2) & (heights < 1.0))),
          "the Ant3D torso left the healthy band (0.2, 1.0)")
    check(x_end > x0, "the Ant3D does not advance in x")

    steady = np.array(step_ms[1:])
    plan_ms = float(np.median(steady))
    log(f"[ant] plan step + env step, host clock after synchronize, steps 2..{plan_steps}: "
        f"median {plan_ms:.3f} ms, min {steady.min():.3f}, max {steady.max():.3f}; "
        f"{rollouts / (plan_ms / 1e3):.1f} rollouts/s")
    profile_plan_steps(cfg, model, env, pstate, state, obs, steps=3, tag="ant")
    return dict(launches=main_launches, plan_ms=plan_ms, rollouts=rollouts)


def phase_spatial_controller(device):
    """MpcICem.get_action built from settings/ant/i-cem-blitz.json as the
    driver builds it: pop 128, h 12, the scanned loop, beta 1.0."""
    from icem_torch.ops import spatial_rollout

    env, ctrl = settings_controller("ant/i-cem-blitz", device,
                                       f"controller_params.seed={SEED + 2}")
    check(ctrl.cfg.cem_loop == "scan" and ctrl.cfg.num_simulated_trajectories == 128
          and ctrl.cfg.horizon == 12, f"Ant settings resolved to {ctrl.cfg}")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    s = env.init_state(gen)
    o = env.observation(s)
    ctrl.beginning_of_rollout(observation=o, state=s)
    before = spatial_rollout.LAUNCHES
    for _ in range(5):
        a = ctrl.get_action(o, s)
        check(a.shape == (8,) and bool(np.all(np.abs(a) <= 1.0)), f"bad action {a}")
        s, o, _, _ = env.step(s, torch.as_tensor(a, device=device))
    n = spatial_rollout.LAUNCHES - before
    check(n == 5 * 4, f"MpcICem on Ant: {n} launches in 5 steps")
    check(bool(torch.isfinite(s).all()), "MpcICem Ant episode state is not finite")
    log(f"[ant] MpcICem.get_action from settings/ant/i-cem-blitz.json, pop 128 h 12 scan: "
        f"5 steps, 4 launches each, last expected cost {float(ctrl.last_expected_cost):.3f}")


def phase_humanoid(device, plan_steps: int):
    """HumanoidStandup3D at the same configuration, a few plan steps."""
    from icem_torch.controllers import icem as ic
    from icem_torch.envs.humanoid3d import HumanoidStandup3D
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.ops import spatial_rollout

    env = HumanoidStandup3D()
    model = GroundTruthModel(env=env)
    cfg = spatial_path_config(env.action_dim)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    plan_gen = torch.Generator(device=device)
    plan_gen.manual_seed(SEED + 5)
    state = env.init_state(gen)
    obs = env.observation(state)
    pstate = ic.init_state(cfg, env.obs_dim, plan_gen)
    rewards, launches, step_ms = [], [], []
    for _ in range(plan_steps):
        before = spatial_rollout.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ic.plan_step(cfg, model.predict_fn, env.cost_fn, pstate, obs, state)
        pstate = res.state
        state, obs, rew, _ = env.step(state, res.action)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(spatial_rollout.LAUNCHES - before)
        rewards.append(rew)
        check(bool(torch.isfinite(state).all()), "non-finite HumanoidStandup3D state")
    rewards = torch.stack(rewards).cpu().numpy()
    log(f"[humanoid] HumanoidStandup3D pop {cfg.num_simulated_trajectories} h {cfg.horizon} "
        f"scan, {plan_steps} plan steps: launches {launches}; rewards "
        f"{np.array2string(rewards, precision=3, max_line_width=200)}; torso height "
        f"{float(state[2]):.3f}; plan step + env step ms "
        + " ".join(f"{v:.1f}" for v in step_ms))
    check(all(n == 4 for n in launches), f"expected 4 launches per step, got {launches}")
    check(bool(np.all(np.isfinite(rewards))), "non-finite HumanoidStandup3D rewards")


def phase_spatial_times(device, envs, plain):
    """ms per launch of the spatial kernel at each h = 30 shape, beside its
    plain version and its bound."""
    from icem_torch.ops.spatial_rollout import rollout_spatial, rollout_spatial_reference

    out = {}
    for env in envs:
        model, name = env.model, env.name
        P, h = 4115, 30
        Q, QD, A = _spatial_rollout_inputs(env, P, h, device, SEED + 20)
        ms = cuda_ms(lambda: rollout_spatial(model, Q, QD, A), reps=10, warmup=1)
        ops = plain_ops_per_trajectory_step(model, device, rollout_spatial_reference)
        nd, na = model.ndof, len(model.actuator_dof)
        bound_ms, bound_by = rollout_bound_ms(ops, P, h, nd, na)
        plain_ms, steps = plain[name]
        log(f"[times] spatial kernel, {name} P={P} h={h}: {ms:.4f} ms per launch, CUDA events "
            f"over 10 launches; plain version {plain_ms:.1f} ms for the first {steps} steps "
            f"(one call, in the comparison above)")
        log(f"[times]   plain version's operations: {ops:.1f} per trajectory-step, "
            f"{ops * P * h / 1e9:.3f} G per launch; bound {bound_ms:.4f} ms ({bound_by}); "
            f"kernel at {bound_ms / ms * 100:.2f}% of its bound")
        out[name] = dict(ms=ms, plain_ms=plain_ms, plain_steps=steps, bound_ms=bound_ms,
                         bound_by=bound_by, ops=ops)
    ant = envs[0].model
    Q, QD, A = _spatial_rollout_inputs(envs[0], 1, 1, device, SEED + 21)
    step_ms = cuda_ms(lambda: rollout_spatial(ant, Q, QD, A), reps=20)
    log(f"[times] the real Ant3D env step's launch (P=1, h=1): {step_ms:.4f} ms")
    log("[times] library_ms: none; no single PyTorch call computes a spatial rollout")
    return out


# csrc/spatial_step.cuh::SpatialProfGroup, in order
PROFILE_GROUPS = ("io", "step_fk", "velocity", "mass_rows", "energy", "cholesky", "sub_fk",
                  "contact", "rhs", "forward", "backward", "euler")


def phase_spatial_profile(device, envs):
    """Where a warp's cycles go inside the spatial kernel: the profile build
    (-DICEM_SPATIAL_PROFILE, the port's kernel plus marks at which lane 0
    charges the clock64() cycles since the last mark to the phase group that
    just ended), launched at P = 4,115, h = 30; trajectory 0's warp over the
    last launch. These launches count nothing."""
    from icem_torch.ops import _build
    from icem_torch.ops import spatial_rollout as sr

    info = _build.build(PROFILE_DEFINES)
    lib = ctypes.CDLL(str(info.path))
    read = lib.spatial_profile_read
    read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
    P, h = 4115, 30
    for env in envs:
        Q, QD, A = _spatial_rollout_inputs(env, P, h, device, SEED + 20)
        kernel = sr.bind(lib, env.model)
        ms = cuda_ms(lambda: sr.launch_bound(kernel, Q, QD, A), reps=3)
        cycles = (ctypes.c_longlong * len(PROFILE_GROUPS))()
        check(read(cycles) == len(PROFILE_GROUPS), "spatial_profile_read failed")
        total = sum(cycles)
        check(total > 0 and min(cycles) >= 0, f"{env.name}: bad profile {list(cycles)}")
        log(f"[profile] spatial kernel {env.name}, profile build: {ms:.4f} ms per launch at "
            f"P={P} h={h}; trajectory 0's warp, {total} cycles over {h} steps: "
            + ", ".join(f"{g} {100.0 * c / total:.2f} %"
                        for g, c in sorted(zip(PROFILE_GROUPS, cycles), key=lambda x: -x[1])))


# ---------------------------------------------------------------------------
# the other controllers: vanilla CEM and random shooting through both kernels

# (P, h) of the other controllers' planner launches: vanilla CEM as
# settings/halfcheetah_running/cem-std.json ships it (3 iterations at P = 97)
# and random shooting at the JAX package's defaults (one launch at P = 40)
CEM_STD_SHAPE = (97, 30)
RANDOM_SHAPE = (40, 30)


def other_controllers(env, device):
    """(registry name, controller, planner launches per step) of vanilla CEM
    and random shooting on ``env``, built through the registry as the driver
    builds them: MpcCemStd with cem-std.json's controller parameters,
    MpcRandom with the JAX package's defaults."""
    from icem_torch.main import get_controllers
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    cem = apply_overrides(resolve_settings("settings/halfcheetah_running/cem-std.json"),
                          [f"controller_params.seed={SEED + 9}"])
    rnd = apply_overrides(cem, ["controller=mpc-random", "controller_params={}",
                                f"controller_params.seed={SEED + 10}"])
    model = GroundTruthModel(env=env)
    ctrl_cem = get_controllers(cem, env, model, device)[1]
    ctrl_rnd = get_controllers(rnd, env, model, device)[1]
    check((ctrl_cem.cfg.num_simulated_trajectories, ctrl_cem.cfg.horizon) == CEM_STD_SHAPE
          and (ctrl_rnd.num_sim_traj, ctrl_rnd.horizon) == RANDOM_SHAPE,
          f"the controllers resolved to {ctrl_cem.cfg} and {vars(ctrl_rnd)}")
    return [("mpc-cem-std", ctrl_cem, ctrl_cem.cfg.opt_iterations), ("mpc-random", ctrl_rnd, 1)]


def phase_other_controllers(device, steps: int = 5):
    """``MpcCemStd.get_action`` and ``MpcRandom.get_action`` on HalfCheetah
    (kernel B1) and Ant3D (kernel B2), and vanilla CEM on an Ant3D that
    repeats its actions twice (no whole-horizon rollout: every sub-step is
    an h = 1 launch). Each: finite actions in the bounds and the launches
    per step (counts set to 0 just before, read just after). Returns the
    launches of each kernel."""
    from icem_torch.envs import env_from_string
    from icem_torch.envs.ant3d import Ant3D
    from icem_torch.main import get_controllers
    from icem_torch.models.ground_truth import GroundTruthModel
    from icem_torch.ops import planar_rollout, spatial_rollout
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    cheetah_settings = resolve_settings("settings/halfcheetah_running/cem-std.json")
    cheetah = env_from_string(cheetah_settings.env, **cheetah_settings.env_params)
    ant = Ant3D(exclude_current_positions_from_observation=False)
    counters = {"planar": planar_rollout, "spatial": spatial_rollout}
    totals = {k: 0 for k in counters}

    def drive(env, name, ctrl, per_step, kernel, n_steps):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 11)
        s = env.init_state(gen)
        o = env.observation(s)
        ctrl.beginning_of_rollout(observation=o, state=s)
        planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
        launches, step_ms = [], []
        for _ in range(n_steps):
            before = counters[kernel].LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = ctrl.get_action(o, s)
            s, o, _, _ = env.step(s, torch.as_tensor(a, device=device))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(counters[kernel].LAUNCHES - before)
            check(a.shape == (env.action_dim,) and bool(np.all(np.isfinite(a)))
                  and bool(np.all(np.abs(a) <= 1.0)), f"{name} on {env.name}: bad action {a}")
        for k in totals:
            totals[k] += counters[k].LAUNCHES
        other = sum(m.LAUNCHES for k, m in counters.items() if k != kernel)
        check(all(n == per_step for n in launches) and other == 0,
              f"{name} on {env.name}: launches per step {launches} (expected {per_step}), "
              f"{other} of the other kernel")
        check(bool(torch.isfinite(s).all()), f"{name} on {env.name}: state is not finite")
        log(f"[controllers] {name}.get_action on {env.name} (repeat {env.action_repeat}): "
            f"{n_steps} steps, {per_step} {kernel} launches per step; ms per step with the "
            f"real step, host clock after synchronize: "
            + " ".join(f"{t:.2f}" for t in step_ms)
            + f"; last expected cost {float(ctrl.last_expected_cost):.3f}")

    for env, kernel in ((cheetah, "planar"), (ant, "spatial")):
        for name, ctrl, iters in other_controllers(env, device):
            drive(env, name, ctrl, iters + 1, kernel, steps)

    # action repeat on the spatial env: the repeated step is two raw steps
    # on the card, and the planner steps it one sub-step at a time
    repeated = Ant3D(action_repeat=2, exclude_current_positions_from_observation=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 12)
    s = repeated.init_state(gen)
    a = torch.rand(8, generator=gen, device=device) * 2 - 1
    s2, o2, r2, _ = repeated.step(s, a)
    s1, _, r1, _ = ant.step(s, a)
    s1, o1, r1b, _ = ant.step(s1, a)
    err = float((s2 - s1).abs().max())
    check(err <= 1e-5 and float((r2 - r1 - r1b).abs()) <= 1e-4,
          f"Ant3D with action repeat 2 differs from two raw steps by {err:.3e}")
    cem = apply_overrides(resolve_settings("settings/halfcheetah_running/cem-std.json"), [
        "controller_params.num_simulated_trajectories=64", "controller_params.horizon=10",
        f"controller_params.seed={SEED + 13}"])
    ctrl = get_controllers(cem, repeated, GroundTruthModel(env=repeated), device)[1]
    n_iter = ctrl.cfg.opt_iterations
    drive(repeated, "mpc-cem-std", ctrl, 2 * (n_iter * ctrl.cfg.horizon + 1), "spatial", 2)
    log(f"[controllers] Ant3D action repeat 2: the repeated step is two raw steps on the card "
        f"(max |ds| {err:.3e}); pop 64 h 10: {n_iter} x 10 x 2 h = 1 launches a plan step")
    return totals


# ---------------------------------------------------------------------------
# the learned models: EnsembleModel and RSSM, trained and planned by the driver

# the learned-model settings, each cut to 1 random initial episode and 1
# training iteration: (settings, overrides beyond those, the steps of the
# episode the idle share is taken over). The ensembles' epochs as shipped.
_PLANET_CUTS = ("rollout_params.task_horizon=25", "forward_model_params.train_steps=20")
LEARNED_RUNS = (
    # the fused device episode; 100 of its 1,000 steps
    ("halfcheetah_running/ensemble-icem", ("rollout_params.task_horizon=100",), 5),
    # the fused device episode, 120 steps as shipped (2 episodes an iteration)
    ("pendulum/ensemble-icem", (), 5),
    # the host-driven episode loop (fuse_on_device false): 25 control steps
    # of 125-250, 20 of the 100 updates a training (about 54 ms each)
    ("planet/cheetah_run", _PLANET_CUTS, 2),
    ("planet/cartpole_swingup", _PLANET_CUTS, 2),
    ("planet/reacher_easy", _PLANET_CUTS, 2),
)
LEARNED_CUTS = ("initial_number_of_rollouts=1", "training_iterations=1")
# card against CPU, the same weights and draws: float32 sums of up to 200
# terms in another order
LEARNED_TOL = dict(atol=1e-4, rtol=1e-4)


def learned_model(name: str, device, *overrides):
    """(env, model, resolved settings) of ``settings/<name>.json``: the model
    built through the registry with the settings' own widths."""
    from icem_torch.envs import env_from_string
    from icem_torch.models import forward_model_from_string
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    params = apply_overrides(resolve_settings(f"settings/{name}.json"), list(overrides))
    env = env_from_string(params.env, **params.get("env_params", {}))
    model = forward_model_from_string(params.forward_model)(
        env=env, device=device, **params.get("forward_model_params", {}))
    return env, model, params


def _max_err(card, cpu, what: str) -> float:
    card, cpu = card.detach().cpu().numpy(), cpu.detach().numpy()
    check(np.allclose(card, cpu, **LEARNED_TOL),
          f"{what}: the card and the CPU differ by {np.abs(card - cpu).max():.3e}")
    return float(np.abs(card - cpu).max())


def _steps_agree(card_model, cpu_model, lr: float, what: str) -> float:
    """The weights after one update on the card against the CPU's: the
    first-Adam-step rule of tests/test_torch_ensemble.py, with the CPU's
    gradient (entries with |g| > 1e-6 max|g| at 1e-5, the others at 2 lr)."""
    card = dict(card_model.net.named_parameters())
    grads = {k: p.grad for k, p in cpu_model.net.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads.values())
    worst = worst_firm = 0.0
    loose = 0
    for k, p in cpu_model.net.named_parameters():
        diff = (card[k].detach().cpu() - p.detach()).abs()
        firm = grads[k].abs() > 1e-6 * gmax
        loose += int((~firm).sum())
        check(bool((diff[firm] <= 1e-5).all()) and bool((diff[~firm] <= 2 * lr).all()),
              f"{what}: {k} differs by {float(diff.max()):.3e} after one update")
        worst = max(worst, float(diff.max()))
        worst_firm = max(worst_firm, float(diff[firm].max()) if bool(firm.any()) else 0.0)
    log(f"[learned]   {what}: one update on an injected batch, card against CPU: max |dw| "
        f"{worst_firm:.3e} where |g| > 1e-6 max|g|, {worst:.3e} over all ({loose} entries "
        f"with |g| <= 1e-6 max|g|, held at 2 lr)")
    return worst_firm


def phase_learned_models_vs_cpu(device) -> float:
    """Each learned model of the five settings, built on the card through the
    registry at the settings' widths, against a CPU copy of its weights: one
    ``apply_fn`` step at the planner's population with injected draws, and
    one update on an injected batch. Returns the largest error."""
    from icem_torch.main import get_controllers
    from icem_torch.models.rssm import RSSMModel

    worst = 0.0
    for name, *_ in LEARNED_RUNS:
        env, card, params = learned_model(name, device)
        cpu = type(card)(env=env, device="cpu", **params.forward_model_params)
        rng = np.random.default_rng(SEED + 30)
        # non-trivial normalizers (the models' buffers), the same on both
        for k, v in card.net.named_buffers():
            noise = rng.uniform(0.5, 2.0, v.shape) if k.endswith("std") \
                else rng.normal(size=v.shape)
            v.copy_(torch.as_tensor(noise, dtype=torch.float32))
        cpu.net.assign(card.params)
        ctrl = get_controllers(params, env, card, device)[1]
        P = ctrl.cfg.num_simulated_trajectories + (
            ctrl.cfg.elites_kept if ctrl.cfg.shift_elites_over_time
            or ctrl.cfg.keep_previous_elites else 0)
        obs = rng.normal(size=(P, env.obs_dim)).astype(np.float32)
        act = rng.uniform(-1, 1, (P, env.action_dim)).astype(np.float32)
        on = lambda a, dev: torch.as_tensor(a, device=dev)
        if isinstance(card, RSSMModel):
            h = rng.normal(size=(P, card.det_dim)).astype(np.float32)
            z = rng.normal(size=(P, card.stoch_dim)).astype(np.float32)
            n = rng.standard_normal((P, card.stoch_dim)).astype(np.float32)
            outs = [m.apply_fn(m.params, {"h": on(h, m.device), "z": on(z, m.device)}, None,
                               on(act, m.device), normals=on(n, m.device)) for m in (card, cpu)]
            pairs = [(outs[0][0][k], outs[1][0][k], k) for k in ("h", "z")]
            L, B = card.seq_length, card.batch_size
            batch = [a.astype(np.float32) for a in (
                rng.normal(size=(L, B, env.obs_dim)), rng.uniform(-1, 1, (L, B, env.action_dim)),
                rng.normal(size=(L, B)), rng.standard_normal((L, B, card.stoch_dim)))]
            losses = [m.fit_step(*(on(a, m.device) for a in batch))[0] for m in (card, cpu)]
            lr = card.learning_rate
        else:
            members = rng.integers(0, card.ensemble_size, P)
            outs = [m.apply_fn(m.params, {}, on(obs, m.device), on(act, m.device),
                               members=on(members, m.device)) for m in (card, cpu)]
            pairs = []
            N = card.batch_size
            x = rng.normal(size=(N, card.in_dim)).astype(np.float32)
            t = rng.normal(size=(N, card.out_dim)).astype(np.float32)
            idx = rng.integers(0, N, (card.ensemble_size, N))
            losses = [m.fit_epoch(on(x, m.device), on(t, m.device), on(idx, m.device))[0]
                      for m in (card, cpu)]
            lr = card.learning_rate
        pairs += [(outs[0][1], outs[1][1], "next obs"), (outs[0][2], outs[1][2], "reward")]
        errs = [_max_err(a, b, f"{name} {what}") for a, b, what in pairs]
        loss_err = _max_err(losses[0], losses[1], f"{name} training loss")
        log(f"[learned] {name}: {type(card).__name__} "
            f"{sum(p.numel() for p in card.net.parameters())} weights; apply_fn at P = {P} on "
            f"the card against the CPU: max |err| {max(errs):.3e} "
            f"({', '.join(f'{w} {e:.2e}' for (_, _, w), e in zip(pairs, errs))}); training "
            f"loss {float(losses[1]):.4f}, |err| {loss_err:.3e}")
        worst = max(worst, *errs, _steps_agree(card, cpu, lr, name))
    return worst


@contextlib.contextmanager
def timed_train(cls):
    """Seconds of each ``cls.train`` call, synchronised, while inside."""
    times, train = [], cls.train

    def timed(self, buffer):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(self, buffer)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    cls.train = timed
    try:
        yield times
    finally:
        cls.train = train


def phase_learned_driver(device, workdir: str):
    """``icem_torch.main.run`` on the five learned-model settings, cut as
    LEARNED_RUNS says, under a temporary model_dir: the model trains after
    each iteration and the planner plans with its live weights. Each run:
    kernel B1's launches (the planar envs' real steps; counts set to 0 just
    before, read just after), ms per control step, train seconds per
    iteration, the return, the host waits, and the device idle share over a
    short episode of the same settings. Returns the launches of each kernel."""
    from icem_torch import main as tmain
    from icem_torch.envs.planar_base import PlanarEnv
    from icem_torch.models import forward_model_from_string
    from icem_torch.ops import planar_rollout, spatial_rollout
    from icem_torch.runtime.config import apply_overrides, resolve_settings
    from icem_torch.runtime.rollout import RolloutManager

    totals = {"planar": 0, "spatial": 0}
    for i, (name, overrides, idle_steps) in enumerate(LEARNED_RUNS):
        tag = name.replace("/", "_")
        params = apply_overrides(resolve_settings(f"settings/{name}.json"), [
            *LEARNED_CUTS, *overrides, f"model_dir={os.path.join(workdir, f'learned_{tag}')}",
            f"seed={SEED}"])
        env, model, _ = learned_model(name, device, *LEARNED_CUTS, *overrides)
        steps = (params.initial_number_of_rollouts
                 + params.training_iterations * params.number_of_rollouts) \
            * params.rollout_params.task_horizon
        expected = steps * env.action_repeat if isinstance(env, PlanarEnv) else 0
        planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
        with host_waits() as waits, timed_train(type(model)) as train_s:
            t0 = time.perf_counter()
            info = tmain.run(params, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"planar": planar_rollout.LAUNCHES, "spatial": spatial_rollout.LAUNCHES}
        for k in totals:
            totals[k] += launches[k]
        check(info["step"] == [0, 1], f"{name}: iterations {info['step']}")
        check(launches == {"planar": expected, "spatial": 0},
              f"{name}: launches {launches}, expected {expected} of the planar kernel")
        rets = info["train_mean_return"]
        check(bool(np.all(np.isfinite(rets))), f"{name}: non-finite returns {rets}")
        logged = [json.loads(line) for line in open(os.path.join(params.model_dir,
                                                                 "metrics.jsonl"))]
        trained = {e["key"]: [] for e in logged if e["key"].startswith("model_")}
        for e in logged:
            if e["key"] in trained:
                trained[e["key"]].append(e["value"])
        check(bool(trained) and all(len(v) == 2 and np.all(np.isfinite(v))
                                    for v in trained.values()),
              f"{name}: the model's training metrics {trained}")
        check("forward_model" in os.listdir(os.path.join(params.model_dir,
                                                         "checkpoints_latest")),
              f"{name}: no forward_model in the checkpoint")
        check(len(train_s) == 2, f"{name}: {len(train_s)} train() calls")
        exec_s = info["train_exec_time"]
        per_iter = [e * 1e3 / (n * params.rollout_params.task_horizon) for e, n in
                    zip(exec_s, (params.initial_number_of_rollouts, params.number_of_rollouts))]
        log(f"[learned] settings/{name}.json {' '.join(LEARNED_CUTS + overrides)}: "
            f"{type(model).__name__}, fuse_on_device {params.rollout_params.fuse_on_device}; "
            f"returns per iteration {', '.join(f'{r:.2f}' for r in rets)} (random, then the "
            f"planner after one training); ms per control step, random then planner: "
            f"{per_iter[0]:.3f}, {per_iter[1]:.3f}; train s per iteration "
            f"{', '.join(f'{t:.3f}' for t in train_s)}; last training "
            f"{ {k: round(v[-1], 4) for k, v in trained.items()} }; run() {wall:.3f} s; "
            f"launches {launches} ({env.action_repeat} a control step of the real env); "
            f"{waits[0]} host waits for the card in the whole run")
        log(f"[learned]   host waits by source line: {dict(waits[1].most_common(6))}")

        # the device idle share over a short episode of the planner, with
        # the model's fresh weights
        ctrl = tmain.get_controllers(params, env, model, device)[1]
        rm = RolloutManager(env, {**params.rollout_params, "task_horizon": idle_steps},
                            device=device)
        rm.sample(ctrl)  # first launches at these shapes: cuBLAS handles, caches
        profile_window(lambda: rm.sample(ctrl), idle_steps, f"learned {i}_{tag}")
    return totals


# ---------------------------------------------------------------------------
# the experiment driver: python -m icem_torch.main's run() on shipped settings

# (settings, overrides, kernel the run launches or None, control steps of
# the whole run, kernel launches of the whole run, the least return it must
# reach or None for finite only, the index of the root's pitch angle in the
# observation or None, the steps of the episode the idle share is taken over:
# 20 for the device-bound runs, 2-10 for the host-bound ones)
DRIVER_RUNS = (
    # past +-pi/2 the flip penalty of the cost is a constant: the pitch
    # angle tells a running cheetah from a rolling one
    ("halfcheetah_running/i-cem-blitz", (), "planar", 1000, 4 * 1000, 3000.0, 1, 20),
    ("ant/i-cem-blitz", (), "spatial", 300, 4 * 300, 300.0, None, 20),
    ("humanoid/i-cem-blitz", (), "spatial", 300, 4 * 300, None, None, 20),
    # 5 episodes of 210 steps exceed SpatialEnv.fused_episode_step_limit
    # (1,000): the rollout manager runs them in 2 chunks of 105 steps
    ("humanoid_standup/i-cem-blitz", ("rollout_params.task_horizon=210",), "spatial",
     5 * 210, 4 * 5 * 210, None, None, 20),
    # a terminating env: 4 planner launches and the real step's, frozen
    # after termination. Its return is held finite only: whether the hopper
    # falls in its first steps depends on the seed in both packages (the
    # JAX package on the CPU with these settings: seed 0 returns 2.39, seeds
    # 1-3 over 100 steps 95.34, 96.08, 0.45; PERF.md §6)
    ("hopper/i-cem-blitz", ("rollout_params.task_horizon=500",), "planar", 500, 5 * 500, None,
     None, 20),
    # analytic envs, no kernel: the pendulum's 3 iterations of 120 steps,
    # held to its own solve threshold (avg_return_required_to_solve); the
    # idle windows of the pendulum and FetchReach over 3 steps (were 10),
    # of the mountain car and the GT cart-pole over 1 (were 2: 12 and 37 s
    # of profiler work): the sharded phase's share of the script's time
    ("pendulum/i-cem-blitz", (), None, 3 * 120, 0, -300.0, None, 3),
    # 180-240 ms a control step (600 small steps of the env a plan step):
    # 1 of the 3 iterations, its episode cut from 200 to 110 steps (the car
    # reaches the goal at step 106 with seed 0; a device episode plans on
    # after the end, frozen)
    ("mountain_car/i-cem-best", ("training_iterations=1", "rollout_params.task_horizon=110"),
     None, 110, 0, 90.0, None, 1),
    # action repeat 8 and the scanned loop, 590-820 ms a control step (960
    # raw steps a plan step): 1 of the 2 iterations, its episode cut from
    # 125 to 5 steps, to keep the script near 600 s
    ("planet/cartpole_swingup_gt", ("rollout_params.task_horizon=5", "training_iterations=1"),
     None, 5, 0, None, None, 1),
    # vanilla CEM, the paper's baseline, as shipped: pop 97, h 30, 3
    # iterations at P = 97 and the real step (the JAX package's v5e runs
    # return 4,940-4,989: results/QUALITY_r05.json)
    ("halfcheetah_running/cem-std", (), "planar", 1000, 4 * 1000, 2000.0, 1, 20),
    # the goal-conditioned analytic envs as shipped, no kernel; their
    # success rates are printed beside the returns
    ("fetch_reach/i-cem-blitz", (), None, 50, 0, None, None, 3),
    # FPP, Door and Relocate over 3 steps of idle window, FPP 25 of its 50
    # steps and Door and Relocate 50 of their 200:
    # the learned-model, autodiff and video phases' share of the script's time
    ("fpp/i-cem-blitz", ("rollout_params.task_horizon=25",), None, 25, 0, None, None, 3),
    ("door/i-cem-blitz", ("rollout_params.task_horizon=50",), None, 50, 0, None, None, 3),
    ("relocate/i-cem-blitz", ("rollout_params.task_horizon=50",), None, 50, 0, None, None, 3),
    # a random initial phase (the learned-model settings' first iteration)
    # in front of the HalfCheetah planner, 200-step episodes: the random
    # policy launches only the real step
    ("halfcheetah_running/i-cem-blitz", ("initial_controller=random",
                                         "initial_number_of_rollouts=1",
                                         "rollout_params.task_horizon=200"), "planar",
     2 * 200, 200 + 4 * 200, 0.0, None, 20),
)


@contextlib.contextmanager
def host_waits():
    """Counts the operations that make the host wait for the card, by
    torch.cuda.set_sync_debug_mode("warn"): each one warns. Yields a list
    that receives the count and the count per source line."""
    counted = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield counted
    finally:
        torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught if "synchroniz" in str(w.message)]
    counted.append(len(waits))
    counted.append(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in waits))


def phase_driver_times(device, planar_shapes, spatial_cases):
    """ms per launch of both kernels at the shapes the driver launches,
    CUDA events over 20 launches, on strided rows as the env passes them,
    each beside its bound. ``spatial_cases``: (env, P, h)."""
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops.planar_rollout import rollout_planar
    from icem_torch.ops.spatial_rollout import rollout_spatial, rollout_spatial_reference

    def bound(model, P, h, ops):
        bound_ms, bound_by = rollout_bound_ms(ops, P, h, model.ndof, len(model.actuator_dof))
        return f"bound {bound_ms:.4g} ms ({bound_by})"

    model = HalfCheetah().model
    ops = plain_ops_per_trajectory_step(model, device)
    for P, h in planar_shapes:
        Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED)
        ms = cuda_ms(lambda: rollout_planar(model, Q, QD, A), reps=20, warmup=2)
        log(f"[times] driver shape: planar kernel, HalfCheetah P={P} h={h}: {ms:.4f} ms per "
            f"launch; {bound(model, P, h, ops)}")
    spatial_ops = {}
    for env, P, h in spatial_cases:
        if env.name not in spatial_ops:
            spatial_ops[env.name] = plain_ops_per_trajectory_step(env.model, device,
                                                                  rollout_spatial_reference)
        Q, QD, A = _spatial_rollout_inputs(env, P, h, device, SEED + 20)
        ms = cuda_ms(lambda: rollout_spatial(env.model, Q, QD, A), reps=20, warmup=2)
        log(f"[times] driver shape: spatial kernel, {env.name} P={P} h={h}: {ms:.4f} ms per "
            f"launch; {bound(env.model, P, h, spatial_ops[env.name])}")


def drive_settings(device, workdir: str, tag: str, run) -> tuple:
    """``icem_torch.main.run`` on one entry of DRIVER_RUNS under a temporary
    model_dir: the kernel launches of the run (counts set to 0 just before
    it, read just after), its return, ms per control step and env steps/s
    (from the run's own train_exec_time, which times the episodes), the host
    waits for the card it made, and the device idle share over a short
    episode of the same settings. Returns (launches per kernel, ms per
    control step)."""
    import pickle

    from icem_torch import main as tmain
    from icem_torch.ops import planar_rollout, spatial_rollout
    from icem_torch.runtime.config import apply_overrides, resolve_settings
    from icem_torch.runtime.rollout import RolloutManager

    name, overrides, kernel, steps, expected, least, pitch, idle_steps = run
    counters = {"planar": planar_rollout, "spatial": spatial_rollout}
    params = apply_overrides(resolve_settings(f"settings/{name}.json"), [
        *overrides, f"model_dir={os.path.join(workdir, tag)}", f"seed={SEED}"])
    planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
    with host_waits() as waits:
        t0 = time.perf_counter()
        info = tmain.run(params, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    syncs = waits[0]
    ret = info["train_mean_return"][-1]
    initial = params.initial_number_of_rollouts if params.initial_controller != "none" else 0
    check(steps == (params.training_iterations * params.number_of_rollouts + initial)
          * params.rollout_params.task_horizon, f"{name}: the run is not {steps} steps")
    exec_s = float(np.sum(info["train_exec_time"]))
    ms_step = exec_s * 1e3 / steps
    success = ""
    if "train_mean_success" in info:
        success = (f"; success rate of the last step, per iteration "
                   f"{', '.join(f'{x:.2f}' for x in info['train_mean_success'])}")
    log(f"[driver] settings/{name}.json{' ' + ' '.join(overrides) if overrides else ''}: "
        f"{initial} + {params.training_iterations} x {params.number_of_rollouts} x "
        f"{params.rollout_params.task_horizon} steps; last iteration's return "
        f"{ret:.2f} (std {info['train_std_return'][-1]:.2f}; per iteration "
        f"{', '.join(f'{r:.2f}' for r in info['train_mean_return'])}); episodes {exec_s:.3f} s, "
        f"{ms_step:.3f} ms per control step, {steps / exec_s:.1f} env steps/s; run() "
        f"{wall:.3f} s in all; launches {launches}; {syncs} host waits for the card "
        f"in the whole run{success}")
    log(f"[driver]   host waits by source line: {dict(waits[1].most_common(8))}")
    with open(os.path.join(params.model_dir, "checkpoints_latest", "rollout_buffer.pkl"),
              "rb") as f:
        episodes = pickle.load(f)
    note = ""
    if pitch is not None:
        angle = np.concatenate([r["observations"][:, pitch] for r in episodes])
        past = np.flatnonzero(np.abs(angle) > np.pi / 2)
        note = (f"; root pitch in [{angle.min():.3f}, {angle.max():.3f}] rad, first past "
                f"+-pi/2 at step {past[0] if len(past) else 'none'}")
    log(f"[driver]   episode lengths {[len(r) for r in episodes]}{note}")
    got = 0 if kernel is None else launches[kernel]
    check(got == expected and sum(launches.values()) == expected,
          f"{name}: launches {launches}, expected {expected} of {kernel}")
    check(np.isfinite(ret), f"{name}: non-finite return {ret}")
    if least is not None:
        check(ret > least, f"{name}: return {ret:.2f} not above {least}")
    # the episode loop itself makes none: what remains is set-up,
    # checkpoints and one copy per chunk, at most 10 an iteration
    check(syncs < max(steps // 10, 10 * params.training_iterations),
          f"{name}: {syncs} host waits in {steps} steps")

    # the device idle share over a short episode of the same settings
    env, ctrl = settings_controller(name, device, *overrides, f"seed={SEED}")
    rm = RolloutManager(env, {**params.rollout_params, "task_horizon": idle_steps},
                        device=device)
    rm.sample(ctrl)  # first launches of this env's model: binding, caches
    profile_window(lambda: rm.sample(ctrl), idle_steps, f"driver {tag}")
    return launches, ms_step


def phase_driver(device, workdir: str):
    """``drive_settings`` on every entry of DRIVER_RUNS, the shipped
    i-cem-blitz settings and the others. Returns (the launches of each
    kernel, ms per control step by settings name and overrides)."""
    with host_waits() as probe:  # the counter sees a read-back
        float(torch.ones((), device=device))
    check(probe[0] >= 1, "set_sync_debug_mode('warn') counted no host wait for .item()")

    totals = {"planar": 0, "spatial": 0}
    ms = {}
    for i, run in enumerate(DRIVER_RUNS):
        launches, ms[run[:2]] = drive_settings(device, workdir, f"{i}_{run[0].split('/')[0]}",
                                               run)
        for k in totals:
            totals[k] += launches[k]
    return totals, ms


def phase_driver_resume(device, workdir: str):
    """A HalfCheetah run of 2 iterations of 20 steps, resumed by a second
    run with load "auto" that continues at iteration 2; and a controller
    saved mid-episode on the card and loaded into a fresh one gives the same
    next action to the bit."""
    from icem_torch import main as tmain
    from icem_torch.runtime.config import apply_overrides, resolve_settings

    md = os.path.join(workdir, "resume")
    base = ["rollout_params.task_horizon=20", f"model_dir={md}", f"seed={SEED}"]
    params = apply_overrides(resolve_settings("settings/halfcheetah_running/i-cem-blitz.json"),
                             base + ["training_iterations=2"])
    first = tmain.run(params, device=device)
    resumed = tmain.run(apply_overrides(params, ["training_iterations=3",
                                                 "checkpoints.load=auto"]), device=device)
    check(first["step"] == [0, 1] and resumed["step"] == [0, 1, 2],
          f"resume: steps {first['step']} then {resumed['step']}")
    check(resumed["train_mean_return"][:2] == first["train_mean_return"],
          "resume: the restored history differs")
    check(os.readlink(os.path.join(md, "checkpoints_latest")) == "checkpoints_002",
          "resume: checkpoints_latest does not point at iteration 2")

    env, ctrl = settings_controller("halfcheetah_running/i-cem-blitz", device, *base)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    state = env.init_state(gen)
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(3):
        a = ctrl.get_action(obs, state)
        state, obs, _, _ = env.step(state, torch.as_tensor(a, device=device))
    path = os.path.join(workdir, "controller")
    ctrl.save(path)
    a_orig = ctrl.get_action(obs, state)
    fresh = settings_controller("halfcheetah_running/i-cem-blitz", device, *base)[1]
    fresh.load(path)
    check(fresh._pstate.generator.device.type == "cuda", "the loaded generator is not on the card")
    a_loaded = fresh.get_action(obs, state)
    check(np.array_equal(a_orig, a_loaded),
          f"the reloaded controller's next action differs: {a_orig} vs {a_loaded}")
    log(f"[driver] resume: iterations {first['step']} then {resumed['step']}; a controller "
        f"saved after 3 steps on the card and loaded into a fresh one gives the same next "
        f"action to the bit: {np.array2string(a_orig, precision=4)}")


# ---------------------------------------------------------------------------
# the autodiff engines and the tooling

AUTODIFF_P = 2
# the energy-audit battery of tests/test_energy_pump.py (tests/test_torch_energy_pump.py)
AUDIT_HORIZON = 12


def _autodiff_envs():
    """Every planar shape (HalfCheetah and PLANAR_ENVS) and both spatial ones."""
    from icem_torch.envs import env_from_string

    return ([env_from_string("HalfCheetah")] + planar_envs()
            + [env_from_string("Ant", exclude_current_positions_from_observation=False),
               env_from_string("HumanoidStandup")])


def _engine(model):
    from icem_torch.envs.physics import planar, spatial

    return spatial if hasattr(model, "axis") else planar


def _one_step(model, Q, QD, A):
    """The autodiff engine's control step of every row, vmapped."""
    return torch.func.vmap(lambda q, qd, a: _engine(model).step(model, q, qd, a))(Q, QD, A)


def _step_limits(env, model, Q, QD, A, q1, qd1):
    """(q, qd) limits of the card's step (q1, qd1) from (Q, QD, A) against
    another engine or device: 1e-4 / 1e-3, or, for a model that amplifies
    roundoff, 4x the gap a one-ulp change of Q opens in the card's own step."""
    if env.name not in AMPLIFIES_ROUNDOFF:
        return 1e-4, 1e-3
    q2, qd2 = _one_step(model, torch.nextafter(Q, torch.full_like(Q, np.inf)), QD, A)
    return (max(1e-4, 4 * float((q1 - q2).abs().max())),
            max(1e-3, 4 * float((qd1 - qd2).abs().max())))


def _audit_battery(model, device):
    """(Q, QD [40, n], A [40, 12, na]): tests/test_energy_pump.py's slams and
    hammering patterns, draw for draw (seed 7)."""
    rng = np.random.default_rng(7)
    n, n_act = model.ndof, len(model.actuator_dof)
    patterns = [np.zeros((AUDIT_HORIZON, n_act))]
    for period in (1, 2, 4):
        sq = np.sign(np.sin(np.arange(AUDIT_HORIZON)[:, None] * np.pi / period + 1e-6))
        patterns.append(np.repeat(sq, n_act, axis=1))
    patterns.append(rng.choice([-1.0, 1.0], (AUDIT_HORIZON, n_act)))
    lo = np.asarray(model.limit_lo, np.float64)
    hi = np.asarray(model.limit_hi, np.float64)
    states = []
    for _ in range(4):
        q = 0.1 * rng.standard_normal(n)
        q[1] = 0.3
        qd = 2.0 * rng.standard_normal(n)
        qd[1] = -8.0
        states.append((q, qd))                       # ground slam
        q2 = q.copy()
        fin = np.isfinite(lo) & np.isfinite(hi)
        q2[fin] = np.where(rng.random(fin.sum()) > 0.5, hi[fin], lo[fin])
        states.append((q2, 6.0 * rng.standard_normal(n)))   # limit slam
    rows = [(q, qd, acts) for q, qd in states for acts in patterns]
    return tuple(torch.tensor(np.stack(x), dtype=torch.float32, device=device)
                 for x in zip(*rows))


def _audit(model, Q, QD, A):
    """Per step of the battery: (excess [40], the end-of-step velocities)."""
    from icem_torch.envs.physics import planar

    audit = torch.func.vmap(lambda q, qd, a: planar.step_with_energy_audit(model, q, qd, a))
    energy = torch.func.vmap(lambda q, qd: planar.stored_energy(model, q, qd))
    q, qd = Q, QD
    e = energy(q, qd)
    for t in range(AUDIT_HORIZON):
        q, qd, w = audit(q, qd, A[:, t])
        e2 = energy(q, qd)
        yield e2 - e - torch.clamp(w, min=0.0), qd
        e = e2


def phase_autodiff(device):
    """[autodiff]: the autodiff engines (envs/physics/planar.py, spatial.py)
    on the card. For each planar shape and both spatial ones: one control
    step of AUTODIFF_P states against the same code on the CPU and against
    kernel B1 / B2 at P = 1, h = 1 from the same states (one step from the
    same inputs: 1e-4 on q, 1e-3 on qd, or 4x the card's own one-ulp gap for
    a model that amplifies roundoff), and its ms per step at P = 1. Then the
    energy-audit battery on the card for HalfCheetah and the Hopper, without
    and with the energy valve, and 20 real steps of a valve HalfCheetah under
    MpcICem. Returns the B1 launches of that run."""
    import dataclasses

    from icem_torch.ops import planar_rollout, spatial_rollout

    for env in _autodiff_envs():
        model, spatial = env.model, hasattr(env.model, "axis")
        Q, QD, A = _spatial_rollout_inputs(env, AUTODIFF_P, 1, device, SEED + 30)
        _one_step(model, Q, QD, A[:, 0])       # first call: constants, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, qd = _one_step(model, Q, QD, A[:, 0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cq, cqd = _one_step(model, *(x.cpu() for x in (Q, QD, A[:, 0])))
        lim_q, lim_qd = _step_limits(env, model, Q, QD, A[:, 0], q, qd)
        cpu_err = (float((q.cpu() - cq).abs().max()), float((qd.cpu() - cqd).abs().max()))
        rollout = spatial_rollout.rollout_spatial if spatial else planar_rollout.rollout_planar
        kq, kqd = zip(*(rollout(model, Q[p:p + 1], QD[p:p + 1], A[p:p + 1])
                        for p in range(AUTODIFF_P)))
        kq, kqd = torch.cat([x[0] for x in kq]), torch.cat([x[0] for x in kqd])
        k_err = (float((q - kq).abs().max()), float((qd - kqd).abs().max()))
        log(f"[autodiff] {env.name} <{model.ndof} dofs>: one step of {AUTODIFF_P} states, card "
            f"against CPU max |dq| {cpu_err[0]:.3e}, |dqd| {cpu_err[1]:.3e}; against kernel "
            f"{'B2' if spatial else 'B1'} at P = 1, h = 1 |dq| {k_err[0]:.3e}, |dqd| "
            f"{k_err[1]:.3e} (limits {lim_q:.1e} / {lim_qd:.1e}); {ms:.1f} ms per step "
            f"(host clock, the second call)")
        for what, (eq, eqd) in (("the CPU", cpu_err), ("the kernel", k_err)):
            check(eq < lim_q and eqd < lim_qd,
                  f"autodiff {env.name}: card against {what} |dq| {eq:.3e}, |dqd| {eqd:.3e}")

    from icem_torch.envs import env_from_string

    # with the valve: the JAX test's 1 J bound (the valveless integrator
    # misses it in both packages: tests/test_torch_energy_pump.py)
    for name in ("HalfCheetah", "Hopper"):
        model = dataclasses.replace(env_from_string(name).model, energy_valve=True)
        t0 = time.perf_counter()
        worst, kinetic_left = -np.inf, 0.0
        for excess, qd in _audit(model, *_audit_battery(model, device)):
            check(bool(torch.isfinite(excess).all()), f"audit {name}: non-finite energy")
            worst = max(worst, float(excess.max()))
            over = excess > model.energy_valve_eps + 1e-2
            if bool(over.any()):
                kinetic_left = max(kinetic_left, float(qd[over].abs().max()))
        log(f"[autodiff] energy audit {name} with the valve: worst excess {worst:.4f} J over "
            f"40 trajectories x {AUDIT_HORIZON} steps ({time.perf_counter() - t0:.1f} s); the "
            f"steps above the valve's 0.1 J margin end with |qd| max {kinetic_left:.1e}")
        # the valve bounds what velocities carry: HalfCheetah stays at its
        # margin; where the Hopper's limit slams gain potential energy, the
        # valve has zeroed every velocity
        check(kinetic_left == 0.0, f"audit {name}: the valve left velocity {kinetic_left}")
        if name == "HalfCheetah":
            check(worst < 1.0, f"audit {name}: the valve let {worst:.3f} J through")

    env, ctrl = settings_controller("halfcheetah_running/i-cem-blitz", device, f"seed={SEED}")
    env.model = dataclasses.replace(env.model, energy_valve=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 31)
    state, obs = env.reset_with_mode(gen, "train")
    ctrl.beginning_of_rollout(observation=obs, state=state)
    ctrl.get_action(obs, state)
    planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        a = ctrl.get_action(obs, state)
        state, obs, _, _ = env.step(state, torch.as_tensor(a, device=device))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 20
    launches = {"planar": planar_rollout.LAUNCHES, "spatial": spatial_rollout.LAUNCHES}
    check(bool(torch.isfinite(state).all()), "the valve HalfCheetah's state is not finite")
    # the planner's 3 launches a step; the real step runs the autodiff engine
    check(launches == {"planar": 60, "spatial": 0}, f"valve HalfCheetah launches {launches}")
    log(f"[autodiff] valve HalfCheetah under MpcICem (i-cem-blitz), 20 control steps: "
        f"{ms:.1f} ms per control step (host clock), finite states, root x "
        f"{float(state[0]):.3f}; launches {launches} (the real step on the autodiff engine)")
    return launches


def _avi_frames(path: str) -> int:
    """The frame count of an MJPEG AVI, parsed back: the avih header's
    count, which must equal the movi list's JPEG chunks (each SOI..EOI) and
    the idx1 entries."""
    import struct

    data = open(path, "rb").read()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI "
          and struct.unpack("<I", data[4:8])[0] == len(data) - 8, f"{path}: not a RIFF AVI")
    avih = data.index(b"avih") + 8
    n = struct.unpack("<I", data[avih + 16:avih + 20])[0]
    at, chunks = data.index(b"movi") + 4, 0
    while data[at:at + 4] == b"00dc":
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        jpeg = data[at + 8:at + 8 + size]
        check(jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9", f"{path}: a bad JPEG")
        at += 8 + size + size % 2
        chunks += 1
    idx = data.index(b"idx1")
    check(n == chunks == struct.unpack("<I", data[idx + 4:idx + 8])[0] // 16,
          f"{path}: {n} frames in the header, {chunks} chunks")
    return n


VIDEO_STEPS = 20


def phase_video(device, workdir: str):
    """[video]: ``icem_torch.main.run`` on HalfCheetah and Ant i-cem-blitz,
    VIDEO_STEPS control steps, with rollout_params.record and without: each
    AVI holds one frame per step and parses; ms per control step recorded
    and unrecorded, ms per frame, seconds to write an episode's AVI and GIF,
    host waits; then one get_action with do_visualize_plan="record".
    Returns the kernel launches of the recorded runs."""
    import pickle

    from icem_torch import main as tmain
    from icem_torch.ops import planar_rollout, spatial_rollout
    from icem_torch.runtime.config import apply_overrides, resolve_settings
    from icem_torch.runtime.video import VideoRecorder

    totals = {"planar": 0, "spatial": 0}
    for name, kernel in (("halfcheetah_running/i-cem-blitz", "planar"),
                         ("ant/i-cem-blitz", "spatial")):
        tag = name.split("/")[0]
        per_step = {}
        for recorded in (False, True):
            videos = os.path.join(workdir, f"videos_{tag}")
            params = apply_overrides(resolve_settings(f"settings/{name}.json"), [
                f"rollout_params.task_horizon={VIDEO_STEPS}", "training_iterations=1",
                f"model_dir={os.path.join(workdir, f'video_{tag}_{int(recorded)}')}",
                f"seed={SEED}", *([f"rollout_params.record={videos}"] if recorded else [])])
            planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
            with host_waits() as waits:
                info = tmain.run(params, device=device)
            launches = {"planar": planar_rollout.LAUNCHES, "spatial": spatial_rollout.LAUNCHES}
            per_step[recorded] = info["train_exec_time"][0] * 1e3 / VIDEO_STEPS
            check(launches[kernel] == 4 * VIDEO_STEPS, f"{name}: launches {launches}")
            if not recorded:
                continue
            for k in totals:
                totals[k] += launches[k]
            with open(os.path.join(params.model_dir, "checkpoints_latest",
                                   "rollout_buffer.pkl"), "rb") as f:
                length = len(pickle.load(f)[0])
            frames = _avi_frames(os.path.join(videos, "train_0001.avi"))
            check(frames == length, f"{name}: {frames} frames for {length} steps")
            log(f"[video] {name}: {length} steps recorded, train_0001.avi holds {frames} "
                f"frames and parses, with train_0001.gif and live_frame.png; {waits[0]} host "
                f"waits in the run ({waits[0] / VIDEO_STEPS:.2f} a step); launches {launches}")
        # ms per frame (render_frame on a card state, its copy included) and
        # the write of one episode's files, apart
        env, _ = settings_controller(name, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 32)
        state = env.init_state(gen)
        env.render_frame(state)
        t0 = time.perf_counter()
        frames = [env.render_frame(state) for _ in range(VIDEO_STEPS)]
        frame_ms = (time.perf_counter() - t0) * 1e3 / VIDEO_STEPS
        rec = VideoRecorder(os.path.join(workdir, f"rewrite_{tag}"), "ep", fps=env.get_fps())
        for fr in frames:
            rec.append(fr)
        t0 = time.perf_counter()
        rec.close()
        write_s = time.perf_counter() - t0
        log(f"[video] {name}: {per_step[True]:.3f} ms per control step recorded (the host "
            f"loop, frames and files included) against {per_step[False]:.3f} unrecorded (the "
            f"device loop); {frame_ms:.2f} ms per rendered frame ({frames[0].shape[1]}x"
            f"{frames[0].shape[0]}); {write_s:.3f} s to write a {VIDEO_STEPS}-frame AVI and GIF "
            f"({write_s / VIDEO_STEPS * 1e3:.1f} ms a frame)")

    env, ctrl = settings_controller("halfcheetah_running/i-cem-blitz", device,
                                    "controller_params.do_visualize_plan=record")
    ctrl.plan_video_dir = os.path.join(workdir, "plans")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 33)
    state, obs = env.reset_with_mode(gen, "train")
    ctrl.beginning_of_rollout(observation=obs, state=state)
    ctrl.get_action(obs, state)
    frames = _avi_frames(os.path.join(ctrl.plan_video_dir, "plan_0001.avi"))
    check(frames == ctrl.cfg.horizon, f"plan_0001.avi: {frames} frames, horizon "
                                      f"{ctrl.cfg.horizon}")
    log(f"[video] MpcICem.get_action with do_visualize_plan='record': plan_0001.avi holds the "
        f"{frames} frames of the chosen plan's env replay and parses")
    return totals


# ---------------------------------------------------------------------------
# [sharded]: the sharded planner (icem_torch/parallel) on the card

SHARDED_RANKS = 2
# each rank plans from these settings with sharded=True, 2 plan steps
SHARDED_SETTINGS = ("halfcheetah_running/i-cem-blitz", "ant/i-cem-blitz")
SHARDED_STEPS = 2
SHARDED_TIMEOUT = 240  # seconds the two rank processes may take, start-up included
# one rank under NCCL in this process, through the driver: DRIVER_RUNS'
# entries of the two HalfCheetah planners as shipped, with sharded=true
SHARDED_DRIVER_RUNS = tuple(
    (name, ("controller_params.sharded=true",), *rest) for name, overrides, *rest in DRIVER_RUNS
    if name in ("halfcheetah_running/i-cem-blitz", "halfcheetah_running/cem-std")
    and not overrides)


def sharded_launch_rows(cfg, W: int) -> list:
    """The rows of each CEM iteration's launch on one rank of W: its shard
    of the fresh samples, plus at iteration 0 its slice of the shifted
    elites (parallel/plan.py::plan_step_sharded)."""
    E = cfg.elites_kept
    e_local = -(-E // W) if cfg.shift_elites_over_time and E > 0 else 0
    return [-(-n // W) + (e_local if i == 0 else 0)
            for i, n in enumerate(cfg.population_schedule)]


def emulate_plan_step_sharded(cfg, predict_fn, cost_fn, W, pstate, obs, model_state):
    """plan_step_sharded's spec in one process, on the card: each rank's
    shard regenerated from its rank stream, each rank's batch rolled out
    alone as that rank rolled it out (B1 / B2), then a direct global
    selection over the union of the candidates: no local top-k, no gather.
    (A copy of tests/test_torch_parallel.py's, which imports JAX.)"""
    from icem_torch.controllers import icem as ic
    from icem_torch.models.base import rollout_open_loop, trajectory_cost
    from icem_torch.parallel.plan import rank_generator

    E = cfg.elites_kept
    last_iter = cfg.opt_iterations - 1
    h, d = cfg.horizon, cfg.action_dim
    mean, std, gen = pstate.mean, pstate.std, pstate.generator
    device = mean.device
    have = pstate.have_elites
    e_a, e_c, e_o = pstate.elite_actions, pstate.elite_costs, pstate.elite_last_obs
    stream = pstate.rank_stream
    e_local = -(-E // W) if (cfg.shift_elites_over_time and E > 0) else 0
    for i, n_i in enumerate(cfg.population_schedule):
        n_local = -(-n_i // W)
        if e_local and i == 0:
            last_step = ic.sample_action_sequences(cfg, gen, mean, std, E)[:, -1:, :]
            shifted = torch.cat([e_a[:E, 1:, :], last_step], dim=1)
        cand_a, cand_c, cand_o = [], [], []
        for r in range(W):
            sim = ic.sample_action_sequences(cfg, rank_generator(stream, r, i, device), mean,
                                             std, n_local)
            if cfg.use_mean_actions and i == last_iter and r == 0:
                sim[0] = mean
            valid = torch.ones(n_local, dtype=torch.bool, device=device)
            if e_local and i == 0:
                mine = torch.zeros((e_local, h, d), device=device)
                mine_valid = torch.zeros(e_local, dtype=torch.bool, device=device)
                for j in range(e_local):
                    if r * e_local + j < E:  # else a padding row, invalid
                        mine[j] = shifted[r * e_local + j]
                        mine_valid[j] = have
                sim = torch.cat([sim, mine])
                valid = torch.cat([valid, mine_valid])
            traj = rollout_open_loop(predict_fn, model_state, obs, sim)
            c = trajectory_cost(cost_fn, traj, cfg.cost_along_trajectory,
                                cfg.use_env_reward_as_cost)
            cand_a.append(sim)
            cand_c.append(torch.where(valid & torch.isfinite(c), c, float("inf")))
            cand_o.append(traj.next_observations[-1])
        if i > 0 and cfg.keep_previous_elites and E > 0:
            cand_a.append(e_a[:E])
            cand_c.append(e_c[:E])
            cand_o.append(e_o[:E])
        cand_a, cand_c, cand_o = torch.cat(cand_a), torch.cat(cand_c), torch.cat(cand_o)
        cand_c = torch.where(torch.isfinite(cand_c), cand_c, float("inf"))
        best_a, best_c, best_o = ic.best_candidate(cand_a, cand_c, cand_o)
        mean, std, e_a, e_c, e_o = ic._refit(cfg, mean, std, cand_a, cand_c, cand_o)
        have = True
    mean = torch.cat([mean[1:], mean[-1:]])
    state = ic.ICemState(mean=mean, std=ic.init_std(cfg, device), elite_actions=e_a,
                         elite_costs=e_c, elite_last_obs=e_o, have_elites=have, generator=gen,
                         rank_stream=stream._replace(step=stream.step + 1))
    return ic.PlanResult(action=best_a[0], state=state, expected_cost=best_c,
                         best_actions=best_a, best_last_obs=best_o)


_SHARDED_FIELDS = ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs")


def sharded_rank(rank: int, world: int, store: str, out: str):
    """One rank of the two-rank phase (``chip_smoke.py --sharded-rank``): a
    gloo group over the FileStore ``store``, then ``MpcICem`` from each of
    SHARDED_SETTINGS with sharded=True, SHARDED_STEPS plan steps from the
    script's seeds, each followed by the real env step. Writes each step's
    action and planner state, the launches and the host waits to ``out``."""
    import datetime

    import torch.distributed as dist

    from icem_torch.ops import planar_rollout, spatial_rollout

    device = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    result = {}
    for name in SHARDED_SETTINGS:
        env, ctrl = settings_controller(name, device, "controller_params.sharded=true",
                                        f"controller_params.seed={SEED + 30}")
        check((ctrl._group.rank, ctrl._group.size, ctrl._group.backend) == (rank, world, "gloo"),
              f"rank {rank}: the controller's group is {ctrl._group}")
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 31)
        s = env.init_state(gen)
        o = env.observation(s)
        ctrl.beginning_of_rollout(observation=o, state=s)
        steps, step_ms = [], []
        planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
        with host_waits() as waits:
            for _ in range(SHARDED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = ctrl.get_action(o, s)
                s, o, _, _ = env.step(s, torch.as_tensor(a, device=device))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                st = ctrl._pstate
                steps.append(dict(action=a, **{k: getattr(st, k).cpu() for k in _SHARDED_FIELDS}))
        result[name] = dict(steps=steps, step_ms=step_ms, host_waits=waits[0],
                            launches={"planar": planar_rollout.LAUNCHES,
                                      "spatial": spatial_rollout.LAUNCHES})
    torch.save(result, out)
    dist.destroy_process_group()


def phase_sharded(device, workdir: str, driver_ms: dict):
    """[sharded]: the sharded planner on the card.

    1. One rank under NCCL, in this process: ``icem_torch.main.run`` on the
       HalfCheetah i-cem-blitz and cem-std settings with sharded=true (a
       one-rank group rendezvoused in memory), each as its DRIVER_RUNS entry
       is run and held, beside the unsharded run's ms per control step.
    2. Two ranks on the card, two processes in a gloo group over a FileStore
       (NCCL refuses two ranks on one card): ``MpcICem`` from
       SHARDED_SETTINGS, HalfCheetah (B1) and Ant (B2, the unrolled loop),
       from one state and seed. Both kernels are first held against their
       plain versions at the rows a rank launches. The ranks' actions,
       means, stds and elites must be the same bits, and the same bits as
       ``emulate_plan_step_sharded`` here on the card.

    Returns the launches of each kernel in both parts' driven runs (the
    ranks count their own)."""
    import shutil
    import subprocess

    from icem_torch.controllers import icem as ic
    from icem_torch.ops import planar_rollout, spatial_rollout
    from icem_torch.parallel.plan import close_local_groups, init_rank_stream

    t_phase = time.perf_counter()
    totals = {"planar": 0, "spatial": 0}
    for i, run in enumerate(SHARDED_DRIVER_RUNS):
        launches, ms = drive_settings(device, workdir, f"sharded_{i}", run)
        for k in totals:
            totals[k] += launches[k]
        plain = driver_ms[(run[0], ())]
        log(f"[sharded] one rank, NCCL: settings/{run[0]}.json sharded=true {ms:.3f} ms per "
            f"control step against {plain:.3f} unsharded ({ms / plain:.3f}x); launches "
            f"{launches}")
    close_local_groups()

    # the rows each rank launches, and both kernels at them
    W = SHARDED_RANKS
    ctrls = {name: settings_controller(name, device, f"controller_params.seed={SEED + 30}")
             for name in SHARDED_SETTINGS}
    rows = {name: sharded_launch_rows(ctrl.cfg, W) for name, (_, ctrl) in ctrls.items()}
    cheetah_env, cheetah = ctrls[SHARDED_SETTINGS[0]]
    ant_env, ant = ctrls[SHARDED_SETTINGS[1]]
    log(f"[sharded] rows of a rank's launches at {W} ranks: {rows}")
    log(f"[wall] {time.perf_counter() - t_phase:.1f} s: the one-rank driver runs")
    planar_shapes = [(P, cheetah.cfg.horizon) for P in rows[SHARDED_SETTINGS[0]]]
    spatial_shapes = [(ant_env, P, ant.cfg.horizon) for P in rows[SHARDED_SETTINGS[1]]]
    err, _ = phase_kernel_vs_plain(device, planar_shapes)
    serr, _ = phase_spatial_kernel_vs_plain(device, [(env, P, h, min(h, 10))
                                                     for env, P, h in spatial_shapes])
    phase_driver_times(device, planar_shapes, spatial_shapes)
    log(f"[wall] {time.perf_counter() - t_phase:.1f} s: and both kernels at a rank's rows")

    # two rank processes of this script
    store_dir = tempfile.mkdtemp(dir=workdir)
    outs = [os.path.join(store_dir, f"rank{r}.pt") for r in range(W)]
    logs = [open(os.path.join(store_dir, f"rank{r}.log"), "w") for r in range(W)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                               str(r), str(W), os.path.join(store_dir, "store"), outs[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(W)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SHARDED_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if rcs != [0] * W:
        for r in range(W):
            with open(os.path.join(store_dir, f"rank{r}.log")) as f:
                log(f"[sharded] rank {r} log:\n{f.read()[-4000:]}")
        fail(f"[sharded] the rank processes exited with {rcs} (limit {SHARDED_TIMEOUT} s)")
    results = [torch.load(o, weights_only=False) for o in outs]
    shutil.rmtree(store_dir)

    for name, (env, ctrl) in ctrls.items():
        kernel = "planar" if name.startswith("halfcheetah") else "spatial"
        got = [res[name] for res in results]
        for k in totals:
            totals[k] += sum(g["launches"][k] for g in got)
        per_step = ctrl.cfg.opt_iterations + 1
        check(all(g["launches"] == {"planar": 0, "spatial": 0, kernel: per_step * SHARDED_STEPS}
                  for g in got), f"[sharded] {name}: launches {[g['launches'] for g in got]}")
        # check 1: the ranks agree to the bit
        for step in range(SHARDED_STEPS):
            a, b = got[0]["steps"][step], got[1]["steps"][step]
            check(np.array_equal(a["action"], b["action"])
                  and all(torch.equal(a[k], b[k]) for k in _SHARDED_FIELDS),
                  f"[sharded] {name}, step {step + 1}: the two ranks differ")
        # check 2: so does the one-process emulation on the card
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 31)
        s = env.init_state(gen)
        o = env.observation(s)
        plan_gen = torch.Generator(device=device)
        plan_gen.manual_seed(SEED + 30)
        pstate = ic.init_state(ctrl.cfg, env.obs_dim, plan_gen)._replace(
            rank_stream=init_rank_stream(plan_gen))
        fm = ctrl.forward_model
        model_state = None
        planar_rollout.LAUNCHES = spatial_rollout.LAUNCHES = 0
        for step in range(SHARDED_STEPS):
            model_state = fm.got_actual_observation_and_env_state(
                observation=o, env_state=s, model_state=model_state)
            res = emulate_plan_step_sharded(ctrl.cfg, fm.predict_fn, env.cost_fn, W, pstate, o,
                                            model_state)
            pstate = res.state
            want = got[0]["steps"][step]
            same = np.array_equal(res.action.cpu().numpy(), want["action"]) and all(
                torch.equal(getattr(pstate, k).cpu(), want[k]) for k in _SHARDED_FIELDS)
            gap = np.abs(res.action.cpu().numpy() - want["action"]).max()
            check(same, f"[sharded] {name}, step {step + 1}: the ranks differ from the "
                        f"emulation: |da| = {gap}")
            s, o, _, _ = env.step(s, res.action)
        emulated = {"planar": planar_rollout.LAUNCHES, "spatial": spatial_rollout.LAUNCHES}
        log(f"[sharded] two ranks (gloo over a FileStore, one card): {name} sharded=true, "
            f"{SHARDED_STEPS} plan steps; actions, means, stds and elites of both ranks the "
            f"same bits, and the same bits as the one-process emulation on the card "
            f"({emulated[kernel]} {kernel} launches of each rank's rows); launches per rank "
            f"{got[0]['launches']}; ms per control step (plan + real step) "
            f"{[[round(t, 3) for t in g['step_ms']] for g in got]}; host waits per step "
            f"{[g['host_waits'] / SHARDED_STEPS for g in got]} (the gather's copy to the host "
            f"and back: gloo gathers host tensors); last action "
            f"{np.array2string(got[0]['steps'][-1]['action'], precision=4)}")
    log(f"[sharded] {W} rank processes took {ranks_s:.1f} s with start-up; the phase "
        f"{time.perf_counter() - t_phase:.1f} s on {card_name_and_power_limit()}")
    return totals, err, serr


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's main path runs on the card, not on the CPU")
    try:
        import icem_torch  # noqa: F401
    except ImportError as e:
        fail(f"icem_torch is not importable next to this script: {e}")
    if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of phase_sharded's two
        sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
    device = torch.device("cuda")
    card = card_name_and_power_limit()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t_start = time.perf_counter()
    info = phase_build()

    from icem_torch.envs.ant3d import Ant3D
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.envs.humanoid3d import HumanoidStandup3D

    ant = Ant3D(exclude_current_positions_from_observation=False)
    humanoid = HumanoidStandup3D()
    phase_spatial_build_report(info, {ant.name: ant.model, humanoid.name: humanoid.model})
    phase_planar_build_report(info, {"HalfCheetah": HalfCheetah().model,
                                     **{env.name: env.model for env in planar_envs()}})
    cfg = main_path_config()
    shapes = main_path_shapes(cfg)
    err, plain_ms = phase_kernel_vs_plain(device, shapes)
    phase_colored_noise(device)
    path = phase_main_path(device, cfg, plan_steps=20)
    times = phase_times(device, shapes, plain_ms)
    phase_planar_profile(device, shapes)
    log(f"[wall] {time.perf_counter() - t_start:.1f} s: the HalfCheetah path")

    scfg = spatial_path_config(ant.action_dim)
    P = scfg.num_simulated_trajectories + scfg.elites_kept
    serr, splain = phase_spatial_kernel_vs_plain(device, [
        (ant, P, scfg.horizon, scfg.horizon), (ant, 1, 1, 1),
        (humanoid, P, scfg.horizon, 10), (humanoid, 1, 1, 1)])
    spath = phase_spatial_main_path(device, plan_steps=20)
    phase_spatial_controller(device)
    phase_humanoid(device, plan_steps=5)
    stimes = phase_spatial_times(device, [ant, humanoid], splain)
    phase_spatial_profile(device, [ant, humanoid])
    log(f"[wall] {time.perf_counter() - t_start:.1f} s: the spatial path")

    # the kernels at the shapes the driver launches, from the settings it runs
    cheetah_cfg = settings_controller("halfcheetah_running/i-cem-blitz", device)[1].cfg
    derr, _ = phase_kernel_vs_plain(device, main_path_shapes(cheetah_cfg)[:-1])
    # (env, P, h) of each spatial run's planner launches (the scanned loop:
    # n_0 fresh rows + the elites at every iteration)
    spatial_shapes = []
    for name in ("ant/i-cem-blitz", "humanoid/i-cem-blitz", "humanoid_standup/i-cem-blitz"):
        env, ctrl = settings_controller(name, device)
        spatial_shapes.append((env, ctrl.cfg.num_simulated_trajectories + ctrl.cfg.elites_kept,
                               ctrl.cfg.horizon))
    dserr, _ = phase_spatial_kernel_vs_plain(device, [
        (env, P, h, min(h, 10)) for env, P, h in spatial_shapes])
    phase_driver_times(device, main_path_shapes(cheetah_cfg)[:-1], spatial_shapes)
    log(f"[wall] {time.perf_counter() - t_start:.1f} s: the kernels at the driver's shapes")
    perr = phase_planar_envs(device)
    phase_planar_controllers(device)
    log(f"[wall] {time.perf_counter() - t_start:.1f} s: the other planar shapes")
    # the other controllers' shapes: vanilla CEM and random shooting on
    # HalfCheetah and Ant3D, and the repeated Ant3D's h = 1 launches
    oerr, _ = phase_kernel_vs_plain(device, [CEM_STD_SHAPE, RANDOM_SHAPE])
    oserr, _ = phase_spatial_kernel_vs_plain(device, [
        (ant, *CEM_STD_SHAPE, 10), (ant, *RANDOM_SHAPE, 10), (ant, 64, 1, 1)])
    phase_driver_times(device, [CEM_STD_SHAPE, RANDOM_SHAPE],
                       [(ant, *CEM_STD_SHAPE), (ant, *RANDOM_SHAPE), (ant, 64, 1)])
    other = phase_other_controllers(device)
    log(f"[wall] {time.perf_counter() - t_start:.1f} s: the other controllers")
    lerr = phase_learned_models_vs_cpu(device)
    with tempfile.TemporaryDirectory() as workdir:
        learned = phase_learned_driver(device, workdir)
        log(f"[wall] {time.perf_counter() - t_start:.1f} s: the learned models (card against "
            f"CPU max |err| {lerr:.3e})")
        driver, driver_ms = phase_driver(device, workdir)
        phase_driver_resume(device, workdir)
        log(f"[wall] {time.perf_counter() - t_start:.1f} s: the driver")
        t_new = time.perf_counter()
        autodiff = phase_autodiff(device)
        video = phase_video(device, workdir)
        log(f"[wall] {time.perf_counter() - t_start:.1f} s: the autodiff engines and the video "
            f"phases, {time.perf_counter() - t_new:.1f} s together")
        # last: the sharded planner; it destroys the groups it made
        sharded, sherr, shserr = phase_sharded(device, workdir, driver_ms)
        log(f"[wall] {time.perf_counter() - t_start:.1f} s: the sharded planner")
    log(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s after start-up")
    # each path's launches, read just after it ran with the counts at 0
    launches = {k: driver[k] + other[k] + learned[k] + autodiff[k] + video[k] + sharded[k]
                for k in driver}
    launches["planar"] += path["launches"]
    launches["spatial"] += spath["launches"]
    log(f"[launches] main paths: planar {path['launches']}, spatial {spath['launches']}; "
        f"the other controllers {other}; the learned-model runs {learned}; the driver runs "
        f"{driver}; the valve HalfCheetah {autodiff}; the recorded episodes {video}; the "
        f"sharded planner {sharded}")

    a = stimes[ant.name]
    log(json.dumps({"kernels": [{
        "name": "planar_rollout",
        "route": "cuda",
        "source": "icem_torch/csrc/planar_rollout.cu",
        "replaces": "icem_tpu/ops/planar_rollout.py:103",
        "launches": launches["planar"],
        "max_abs_err": max(err, derr, perr, oerr, sherr),
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }, {
        "name": "spatial_rollout",
        "route": "cuda",
        "source": "icem_torch/csrc/spatial_rollout.cu",
        "replaces": "icem_tpu/ops/spatial_rollout.py:128",
        "launches": launches["spatial"],
        "max_abs_err": max(serr, dserr, oserr, shserr),
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
