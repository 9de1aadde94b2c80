"""The one traffic generator: whole episodes back to back, with the steps
the check reads drawn from the seed.

A mix file (``benchmark/mixes/<traffic>.json``) holds only parameters:

- ``rollout_params``: what the mix sets in the settings' ``rollout_params``
  (``fuse_on_device``: the shipped ``"auto"`` runs device episodes, ``false``
  the host loop);
- ``checked_steps_per_episode``: control steps per episode whose inputs and
  outputs the check reads, drawn from the seed;
- ``warm_up_steps``: the length of the warm-up episode, which captures the
  first-step and steady graph keys;
- ``traced_from``, ``traced_steps``: the stretch of the window's first
  episode that a ``--trace 1`` run profiles.

Every episode runs the configuration's ``task_horizon`` control steps from a
start state the program draws from the run's seed; a new episode starts only
while it can still end inside the window, so the window holds whole
episodes. The recorder observes the timed path at the call of each control
step (the device episode's compiled control step, or ``get_action`` in the
host loop): it copies the inputs and the planner's state at the drawn steps
on the device, without a host wait, and reads the host clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

# the planner state's tensors that the check reads before and after a step
_PLAN_FIELDS = ("mean", "std", "elite_actions", "elite_costs", "elite_last_obs")


class Plan:
    """The steps a run's check reads and the stretch its trace covers."""

    def __init__(self, mx: dict, seed: int, horizon: int):
        self.seed = int(seed)
        self.horizon = int(horizon)
        self.per_episode = int(mx["checked_steps_per_episode"])
        start = min(int(mx.get("traced_from", 0)), max(self.horizon - 1, 0))
        stop = min(start + int(mx.get("traced_steps", 0)), self.horizon)
        self.trace_steps = (start, stop)
        self._samples = {}

    def samples(self, episode: int) -> frozenset:
        """Steps t in [0, horizon - 2] of ``episode`` whose transition to
        t + 1 the check reads; the same for a seed whatever the speed."""
        if episode not in self._samples:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, episode]))
            k = min(self.per_episode, max(self.horizon - 1, 0))
            self._samples[episode] = frozenset(
                int(t) for t in rng.choice(self.horizon - 1, size=k, replace=False))
        return self._samples[episode]


@dataclass
class Episode:
    index: int
    start: float
    end: float
    steps: int
    data: dict            # the Rollout's host arrays
    env_stream: str       # the program's stream of the episode's start state


@dataclass
class Snapshot:
    state: torch.Tensor = None
    before: dict = None
    generator_state: torch.Tensor = None
    after: dict = None
    next_state: torch.Tensor = None


@dataclass
class Recorder:
    plan: Plan
    trace_steps: tuple = None
    device: torch.device = None
    armed: bool = False
    episode: int = 0
    t: int = 0
    snapshots: dict = field(default_factory=dict)
    starts: dict = field(default_factory=dict)     # episode -> [get_action start]
    plans: dict = field(default_factory=dict)      # episode -> [get_action seconds]
    profiler: object = None
    trace_summary: dict = None
    _trace_t0: float = 0.0

    def arm(self):
        self.armed = True

    def disarm(self):
        self.armed = False
        if self.profiler is not None:
            self._stop_trace()

    def begin_episode(self, index: int):
        if self.profiler is not None:
            self._stop_trace()
        self.episode, self.t = index, 0
        self.starts[index] = []
        self.plans[index] = []

    # -- the timed path's calls -------------------------------------------
    def before(self, pstate, state):
        if not self.armed:
            return
        ep, t = self.episode, self.t
        if self.trace_steps is not None and ep == 0:
            if t == self.trace_steps[0] and self.profiler is None:
                self._start_trace()
            elif t == self.trace_steps[1] and self.profiler is not None:
                self._stop_trace()
        samples = self.plan.samples(ep)
        if t in samples:
            snap = self.snapshots.setdefault((ep, t), Snapshot())
            snap.state = state.detach().clone()
            snap.before = _copy_plan(pstate)
            snap.generator_state = pstate.generator.get_state()
        if t - 1 in samples and state is not None:
            snap = self.snapshots[(ep, t - 1)]
            if snap.next_state is None:
                snap.next_state = state.detach().clone()

    def after(self, pstate, next_state=None):
        if not self.armed:
            return
        ep, t = self.episode, self.t
        if t in self.plan.samples(ep):
            snap = self.snapshots[(ep, t)]
            snap.after = _copy_plan(pstate)
            if next_state is not None:
                snap.next_state = next_state.detach().clone()
        self.t += 1

    # -- host-loop timing ----------------------------------------------------
    def control_step_ms(self, exclude_traced: bool = False) -> list:
        """Every control step of the window within an episode: one
        ``get_action`` call's start to the next's, in ms."""
        out = []
        for ep, starts in self.starts.items():
            keep = self._untraced(ep, len(starts) - 1, exclude_traced)
            out.extend(1e3 * (b - a) for i, (a, b) in enumerate(zip(starts, starts[1:]))
                       if keep[i])
        return out

    def plan_ms(self, exclude_traced: bool = False) -> list:
        out = []
        for ep, plans in self.plans.items():
            keep = self._untraced(ep, len(plans), exclude_traced)
            out.extend(1e3 * p for i, p in enumerate(plans) if keep[i])
        return out

    def loop_ms(self, exclude_traced: bool = False) -> list:
        """Each control step less its ``get_action``: the env step, the
        read-backs and the loop's own work."""
        out = []
        for ep, starts in self.starts.items():
            plans = self.plans[ep]
            keep = self._untraced(ep, len(starts) - 1, exclude_traced)
            out.extend(1e3 * (b - a - p) for i, (a, b, p) in
                       enumerate(zip(starts, starts[1:], plans)) if keep[i])
        return out

    def _untraced(self, ep: int, n: int, exclude: bool) -> list:
        keep = [True] * n
        if exclude and ep == 0 and self.trace_steps is not None:
            lo, hi = self.trace_steps
            for i in range(max(lo - 1, 0), min(hi + 1, n)):
                keep[i] = False
        return keep

    # -- the traced stretch --------------------------------------------------
    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profiler.start()
        self._trace_steps_seen = self.t
        self._trace_t0 = time.perf_counter()

    def _stop_trace(self):
        from benchmark import trace as tracing

        with torch.profiler.record_function(tracing.END_MARK):
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._trace_t0
        steps = self.t - self._trace_steps_seen
        self.profiler.stop()
        self.trace_summary = tracing.summarize(self.profiler, window_s, steps)
        self.profiler = None


def _copy_plan(pstate) -> dict:
    out = {name: getattr(pstate, name).detach().clone() for name in _PLAN_FIELDS}
    out["have_elites"] = bool(pstate.have_elites)
    return out


# ---------------------------------------------------------------------------
# the timed path, observed


class ObservedStep:
    """The device episode's compiled control step, called through: the
    recorder sees its inputs and outputs at each call."""

    def __init__(self, step, recorder: Recorder):
        self.step, self.recorder = step, recorder

    def __call__(self, pstate, state, obs, done_before, model_params):
        self.recorder.before(pstate, state)
        out = self.step(pstate, state, obs, done_before, model_params)
        self.recorder.after(out[0], out[1])
        return out


def path_of(manager, controller) -> str:
    """"device" where ``sample`` runs device episodes for this controller,
    else "host" (``RolloutManager.sample``'s own choice)."""
    fuse = manager.fuse_on_device
    fused = bool(fuse) and not manager.record and hasattr(controller, "functional_plan")
    return "device" if fused else "host"


def install(manager, controller, recorder: Recorder) -> str:
    """Observe the timed path of ``controller`` under ``manager``; returns
    the path ("device" or "host")."""
    path = path_of(manager, controller)
    if path == "device":
        step = manager._control_step(controller)
        manager._control_steps[id(controller)] = (controller, ObservedStep(step, recorder))
        return path

    get_action = controller.get_action

    def observed_get_action(obs, state=None, mode="train"):
        t0 = time.perf_counter()
        if recorder.armed:
            recorder.starts[recorder.episode].append(t0)
        recorder.before(controller._pstate, state)
        action = get_action(obs, state, mode=mode)
        if recorder.armed:
            recorder.plans[recorder.episode].append(time.perf_counter() - t0)
        recorder.after(controller._pstate)
        return action

    controller.get_action = observed_get_action
    return path


def warm_up(manager, controller, mx: dict):
    """One short episode on the timed path: it builds and loads the
    kernels and captures every graph key the window's episodes meet."""
    horizon = manager.task_horizon
    manager.task_horizon = int(mx.get("warm_up_steps", 3))
    try:
        manager.sample(controller, mode="train", no_rollouts=1)
    finally:
        manager.task_horizon = horizon


def env_stream(path: str, counter: int, mode: str = "train", epoch: int = 0) -> str:
    """The program's stream of an episode's start state (``RolloutManager``:
    one stream per ``sample`` call, its first episode's env stream under it
    on the device path)."""
    stream = f"rollout/{mode}/{epoch}/{counter}"
    return f"{stream}/0/env" if path == "device" else stream


def window(manager, controller, seconds: float, recorder: Recorder) -> list:
    """Whole episodes back to back while the next can still end inside
    ``seconds``; at least one."""
    path = path_of(manager, controller)
    episodes = []
    t_start = time.perf_counter()
    while True:
        k = len(episodes)
        recorder.begin_episode(k)
        t0 = time.perf_counter()
        rollout = manager.sample(controller, mode="train", no_rollouts=1)[0]
        t1 = time.perf_counter()
        data = {name: np.asarray(rollout[name]) for name in rollout.field_names}
        episodes.append(Episode(k, t0, t1, len(rollout), data,
                                env_stream(path, manager._episode_counter)))
        if (t1 - t_start) + (t1 - t0) > seconds:
            return episodes
