#!/usr/bin/env python3
"""Drive icem_torch's main path on one CUDA card and hold its kernel against
its plain PyTorch version.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``icem_torch/csrc`` (into ``build/``), then:

1. prints the card's name and power limit, the build time and nvcc's register
   and spill report;
2. runs the planar rollout kernel against ``rollout_planar_reference`` on the
   card at every shape the main path launches (HalfCheetah, P = 32,921,
   26,214 and 20,971 at h = 30, and the real env step's P = 1, h = 1);
3. checks the colored-noise synthesis on the card against a float64 numpy
   synthesis of the same white draws, and the variance of a full-width draw;
4. drives the main path: 20 iCEM plan steps on HalfCheetah at population
   32,768 and horizon 30, each followed by one real env step, counting the
   kernel's launches, then a few steps of ``MpcICem.get_action`` at the
   settings file's own population;
5. times the kernel, its plain version and the plan step, and computes the
   kernel's bound from the operations and bytes of this run's shapes.

Every check raises on failure, so the script exits non-zero and prints no
result. It also fails where there is no CUDA device: nothing runs on the CPU.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time

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


def plain_ops_per_trajectory_step(model, device) -> float:
    """Arithmetic operations of ``rollout_planar_reference`` for one
    trajectory and one control step. The row engine has no data-dependent
    branch (every switch is a ``where``), so the count does not depend on
    the inputs and scales exactly with P * h."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from icem_torch.ops.planar_rollout import rollout_planar_reference

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

    P, h = 64, 2
    nd, na = model.ndof, len(model.actuator_dof)
    Q = torch.zeros((P, nd), device=device)
    A = torch.zeros((P, h, na), device=device)
    with Counter() as counter:
        rollout_planar_reference(model, Q, Q, A)
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
    """States near HalfCheetah's init distribution and uniform actions."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nd, na = model.ndof, len(model.actuator_dof)
    Q = torch.rand((P, nd), generator=gen, device=device) * 0.2 - 0.1
    QD = 0.1 * torch.randn((P, nd), generator=gen, device=device)
    A = torch.rand((P, h, na), generator=gen, device=device) * 2.0 - 1.0
    return Q, QD, A


QUANTILES = [0.5, 0.9, 0.99, 0.999, 1.0]


def _quantiles(x: torch.Tensor) -> str:
    return " ".join(f"{v:.3e}" for v in np.quantile(x.cpu().numpy(), QUANTILES))


def _replay_one_step(model, Q, QD, A, qs, qds, rows, steps: int):
    """max |dq| of each step t < ``steps`` of the trajectories ``rows``,
    with the plain version started from the kernel's own state at the start
    of step t: the kernel's one-step error, free of what earlier steps'
    roundoff did. Returns [len(rows), steps]."""
    from icem_torch.ops.planar_rollout import rollout_planar_reference

    starts_q = torch.cat([Q[None], qs[:steps - 1]])[:, rows]     # [steps, n, nd]
    starts_qd = torch.cat([QD[None], qds[:steps - 1]])[:, rows]
    acts = A[rows, :steps].transpose(0, 1)                        # [steps, n, na]
    nd = Q.shape[1]
    rq, _ = rollout_planar_reference(model, starts_q.reshape(-1, nd),
                                     starts_qd.reshape(-1, nd),
                                     acts.reshape(-1, 1, acts.shape[-1]))
    local = (rq[0].reshape(steps, len(rows), nd) - qs[:steps, rows]).abs().amax(-1)
    return local.T


def phase_kernel_vs_plain(device, shapes):
    """The kernel against its plain version at every shape the main path
    launches.

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

    Returns (the largest error checked over the first 3 steps of every
    shape, a diverged trajectory counting with its one-step errors; the
    plain version's ms at the first shape)."""
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops.planar_rollout import rollout_planar, rollout_planar_reference

    model = HalfCheetah().model
    worst, plain_ms = 0.0, None
    for k, (P, h) in enumerate(shapes):
        Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED + k)
        qs, qds = rollout_planar(model, Q, QD, A)
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
              f"kernel output shape {tuple(qs.shape)}")
        check(bool(torch.isfinite(qs).all() and torch.isfinite(qds).all()
                   and torch.isfinite(qs_ulp).all()), f"non-finite kernel output at P={P}")
        check(bool(torch.isfinite(rq).all() and torch.isfinite(rqd).all()),
              f"non-finite plain-version output at P={P}")
        dq = (qs - rq).abs()
        first = min(h, 3)
        per_traj = dq[:first].amax(dim=(0, 2))                       # [P]
        diverged = torch.nonzero(per_traj >= 1e-4).flatten()
        log(f"[kernel] HalfCheetah P={P} h={h}: max |dq| over the first {first} control "
            f"steps = {float(per_traj.max()):.3e}; {len(diverged)} of {P} trajectories "
            f"at 1e-4 or more")
        checked = per_traj.masked_fill(per_traj >= 1e-4, 0.0).max()
        if len(diverged):
            local = _replay_one_step(model, Q, QD, A, qs, qds, diverged, first)
            for p, row in list(zip(diverged.tolist(), local.tolist()))[:8]:
                t = int(dq[:first, p].amax(-1).gt(1e-5).nonzero()[0])
                log(f"[kernel]   trajectory {p} diverges in step {t + 1}: max |dq| "
                    f"{float(per_traj[p]):.3e}; one-step error from the kernel's own "
                    f"states, per step: " + " ".join(f"{v:.2e}" for v in row))
            log(f"[kernel]   largest one-step error of the {len(diverged)} replayed: "
                f"{float(local.max()):.3e}")
            check(float(local.max()) < 1e-4,
                  f"kernel's one-step error {float(local.max()):.3e} >= 1e-4 at P={P}")
            checked = torch.maximum(checked, local.max())
        worst = max(worst, float(checked))
        log(f"[kernel]   largest error checked: {float(checked):.3e} (limit 1e-4)")
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
        log(f"[kernel]   steps {h - 9}-{h}: 0.99 quantile of |dq| {q99:.3e} (limit 1e-3), "
            f"{q99 / q99_ulp:.3f}x the one-ulp gap's {q99_ulp:.3e} (limit 4x)")
        check(q99 < 1e-3 and q99 < 4 * q99_ulp,
              f"late-horizon gap at P={P}: 0.99 quantile {q99:.3e}, one-ulp {q99_ulp:.3e}")
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


def profile_plan_steps(cfg, model, env, pstate, state, obs, steps: int):
    """Where a plan step's time goes: device time by kernel and the device's
    idle share, from torch.profiler over a few steady plan steps (the
    profiler's own overhead lengthens the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from icem_torch.controllers import icem as ic

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            res = ic.plan_step(cfg, model.predict_fn, env.cost_fn, pstate, obs, state)
            pstate = res.state
            state, obs, _, _ = env.step(state, res.action)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = lambda e: e.self_device_time_total
    rows = sorted((e for e in kernels if device_us(e) > 0), key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / steps
    if busy_ms == 0:
        log("[profile] the profiler saw no device time: device busy share not measured")
        return
    log(f"[profile] per plan step + env step under the profiler: wall {wall_ms:.3f} ms, "
        f"kernels {busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}")
    for e in rows[:8]:
        log(f"[profile]   {device_us(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d} "
            f"calls/step  {e.key[:90]}")


def phase_main_path(device, cfg, plan_steps: int):
    from icem_torch.controllers import icem as ic
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.models.ground_truth import GroundTruthModel, ParallelGroundTruthModel
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

    # the controller API at the settings file's own population
    # (settings/halfcheetah_running/i-cem-blitz.json over its defaults)
    ctrl_env = HalfCheetah(exclude_current_positions_from_observation=True,
                           penalise_flipping=True)
    ctrl = ic.MpcICem(env=ctrl_env, forward_model=ParallelGroundTruthModel(env=ctrl_env),
                      horizon=30, num_simulated_trajectories=40,
                      action_sampler_params=dict(noise_beta=0.25, elites_size=10),
                      seed=SEED + 2, sharded="auto", device=device)
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
    log(f"[main] MpcICem.get_action at pop 40: 5 steps, 4 launches each, "
        f"last expected cost {float(ctrl.last_expected_cost):.3f}")
    return dict(launches=main_launches, plan_ms=plan_ms, traj_per_step=traj_per_step,
                late_reward=late)


def phase_times(device, shapes, plain_ms: float):
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.ops.planar_rollout import rollout_planar

    model = HalfCheetah().model
    P, h = shapes[0]
    Q, QD, A = _seeded_rollout_inputs(model, P, h, device, SEED)
    kernel_ms = cuda_ms(lambda: rollout_planar(model, Q, QD, A), reps=20, warmup=2)
    # the real env step: one trajectory, one control step
    step_ms = cuda_ms(lambda: rollout_planar(model, Q[:1], QD[:1], A[:1, :1]), reps=20)
    ops = plain_ops_per_trajectory_step(model, device)
    bound_ms, bound_by = rollout_bound_ms(ops, P, h, model.ndof, len(model.actuator_dof))
    log(f"[times] rollout kernel, HalfCheetah P={P} h={h}: {kernel_ms:.4f} ms per launch, "
        f"CUDA events over 20 launches")
    log(f"[times] plain version at the same shape and inputs: {plain_ms:.1f} ms (one call, "
        f"in the comparison above)")
    log(f"[times] the real env step's launch (P=1, h=1): {step_ms:.4f} ms")
    log(f"[times] plain version's operations: {ops:.1f} per trajectory-step, "
        f"{ops * P * h / 1e9:.3f} G per launch; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32, {PEAK_HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
        f"kernel at {bound_ms / kernel_ms * 100:.1f}% of its bound")
    log("[times] library_ms: none; no single PyTorch call computes a planar rollout")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                ops=ops, P=P)


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's main path runs on the card, not on the CPU")
    try:
        import icem_torch  # noqa: F401
    except ImportError as e:
        fail(f"icem_torch is not importable next to this script: {e}")
    device = torch.device("cuda")
    card = card_name_and_power_limit()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    phase_build()
    cfg = main_path_config()
    shapes = main_path_shapes(cfg)
    err, plain_ms = phase_kernel_vs_plain(device, shapes)
    phase_colored_noise(device)
    path = phase_main_path(device, cfg, plan_steps=20)
    times = phase_times(device, shapes, plain_ms)

    log(json.dumps({"kernels": [{
        "name": "planar_rollout",
        "route": "cuda",
        "source": "icem_torch/csrc/planar_rollout.cu",
        "replaces": "icem_tpu/ops/planar_rollout.py:103",
        "launches": path["launches"],
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
