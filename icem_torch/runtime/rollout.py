"""Episode execution runtime.

Counterpart of ``icem_tpu/runtime/rollout.py`` (the reference's
RolloutManager, icem/misc/rollout_utils.py:38-345), with its two paths:

1. ``_sample`` — the host-driven episode loop: works with any controller
   through ``get_action(obs, state, mode)``, reads every step's observation
   back to the host and stops at ``done`` or at a non-finite observation. An
   episode that renders or records a video takes this loop: a frame of the
   state is drawn on the host before each action.

2. ``sample_on_device`` — the device-resident episode, for a controller with
   ``functional_plan`` / ``init_plan_state`` (the MPC planners). Planner and
   env step run in a Python loop over device tensors with no host round trip
   inside the episode: termination freezes the state with ``torch.where``
   instead of breaking, and the transitions go into one preallocated
   ``[T, width]`` device tensor, a row per step, that reaches the host once
   per chunk. The JAX package runs
   the same loop as one ``lax.scan`` over a vmapped batch of episodes; here
   the episodes of one call run one after another, each with its own env
   and planner generators.

Termination semantics, the same on both paths: a non-finite next
observation or state ends the episode and its own transition is invalid; a
NaN reward on that step is zeroed; ``only_final_reward`` keeps the last
valid reward only.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from icem_torch.device import resolve_device
from icem_torch.runtime.buffer import Rollout, RolloutBuffer
from icem_torch.runtime.seeding import Seeding
from icem_torch.runtime.video import VideoRecorder

# the fields of one device transition, in buffer order
_FIELDS = ("observations", "next_observations", "actions", "rewards", "dones", "keep",
           "successes")


class RolloutManager:
    """reference: misc/rollout_utils.py:38-114 (constructor + sample dispatch).

    ``device``: where episodes run, the card unless the caller asks for the
    CPU (``icem_torch.device.resolve_device``).
    """

    def __init__(self, env, rollout_params, device=None):
        p = dict(rollout_params)
        self.env = env
        self.device = resolve_device(device)
        self.task_horizon = int(p.get("task_horizon", 200))
        self.use_env_states = bool(p.get("use_env_states", False))
        self.only_final_reward = bool(p.get("only_final_reward", False))
        # record: falsy = off; True = "videos"; a string = the directory
        rec = p.get("record", False)
        self.record = rec if isinstance(rec, str) else ("videos" if rec else "")
        # fuse_on_device: true | false | "auto" (default). Auto runs episodes
        # on the device, in chunks where the env sets a step limit
        # (fused_episode_step_limit) that the call exceeds
        self.fuse_on_device = p.get("fuse_on_device", "auto")
        if not isinstance(self.fuse_on_device, str):
            self.fuse_on_device = bool(self.fuse_on_device)
        self._episode_counter = 0
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Fold the training iteration into the episode streams so a resumed
        run does not replay the streams of the first iterations."""
        self._epoch = int(epoch)

    # ------------------------------------------------------------------ #
    def sample(self, policy, render: bool = False, mode: str = "train",
               name: str = "", no_rollouts: int = 1, desc: str = "rollout"):
        """Collect ``no_rollouts`` episodes (rollout_utils.py:89-114)."""
        fuse = self.fuse_on_device
        chunk = None
        if fuse == "auto":
            limit = getattr(self.env, "fused_episode_step_limit", None)
            fuse = True
            if limit is not None and no_rollouts * self.task_horizon > int(limit):
                n_chunks = -(-no_rollouts * self.task_horizon // int(limit))
                chunk = -(-self.task_horizon // n_chunks)
                if not getattr(self, "_warned_auto_chunk", False):
                    self._warned_auto_chunk = True
                    print(f"RolloutManager: fuse_on_device=auto runs the episodes in "
                          f"{n_chunks}x{chunk}-step chunks ({no_rollouts}x"
                          f"{self.task_horizon} steps exceeds the env's step limit of {limit})")
        if fuse and not render and not self.record and hasattr(policy, "functional_plan"):
            return self.sample_on_device(policy, mode=mode, no_rollouts=no_rollouts,
                                         chunk=chunk)
        return [self._sample(policy, render=render, mode=mode, name=name or mode)
                for _ in range(no_rollouts)]

    # ------------------------------------------------------------------ #
    def _episode_stream(self, mode: str) -> str:
        self._episode_counter += 1
        return f"rollout/{mode}/{self._epoch}/{self._episode_counter}"

    def _sample(self, policy, render: bool = False, mode: str = "train", start_state=None,
                name: str = "") -> Rollout:
        """Host-driven canonical env loop (rollout_utils.py:154-227)."""
        env = self.env
        gen = Seeding.generator_for(self._episode_stream(mode), self.device)
        recorder = None
        if self.record:
            recorder = VideoRecorder(self.record, f"{name or mode}_{self._episode_counter:04d}",
                                     fps=env.get_fps())
        if start_state is not None:
            state = start_state
            obs = env.observation(state)
        else:
            state, obs = env.reset_with_mode(gen, mode)

        if hasattr(policy, "beginning_of_rollout"):
            policy.beginning_of_rollout(
                observation=obs, state=state if self.use_env_states else None, mode=mode)

        transitions = []
        successes = []
        start_time = time.time()
        for t in range(self.task_horizon):
            if render or recorder is not None:
                frame = env.render_frame(state)
                if recorder is not None and frame is not None:
                    recorder.append(frame)
            env_state = state if self.use_env_states else None
            action = policy.get_action(obs, env_state, mode=mode)
            action_t = torch.as_tensor(action, dtype=torch.float32, device=self.device)
            next_state, next_obs, reward, done = env.step(state, action_t)
            next_obs_np = next_obs.cpu().numpy()
            if not np.all(np.isfinite(next_obs_np)):
                # physics blow-up containment: end the episode here rather
                # than propagate NaNs (reference rollout_utils.py:189-194)
                print(f"Warning: non-finite observation at step {t}; truncating episode")
                break
            succ = env.is_success(obs, action_t, next_obs)
            if succ is not None:
                successes.append(float(succ))
            transitions.append((obs.cpu().numpy(), next_obs_np, np.asarray(action),
                                float(reward), float(done)))
            state, obs = next_state, next_obs
            if float(done):
                break

        if recorder is not None:
            path = recorder.close()
            if path:
                print(f"recorded episode video: {path}")
        if not transitions:  # first-step blow-up: empty rollout, not a crash
            z = np.zeros((0, env.obs_dim), np.float32)
            za = np.zeros((0, env.action_dim), np.float32)
            return Rollout(data=dict(observations=z, next_observations=z,
                                     actions=za, rewards=np.zeros(0, np.float32),
                                     dones=np.zeros(0, np.float32)))
        obs_a, nxt_a, act_a, rew_a, done_a = map(np.array, zip(*transitions))
        if self.only_final_reward:
            rew_a[:-1] = 0.0
        data = dict(observations=obs_a, next_observations=nxt_a, actions=act_a,
                    rewards=rew_a, dones=done_a)
        if successes:
            data["successes"] = np.array(successes, np.float32)
        if hasattr(policy, "end_of_rollout"):
            policy.end_of_rollout(time.time() - start_time, float(rew_a.sum()), mode)
        return Rollout(data=data)

    # ------------------------------------------------------------------ #
    def sample_on_device(self, policy, mode: str = "train", no_rollouts: int = 1,
                         chunk: Optional[int] = None):
        """Device-resident episodes: planner and env step on device tensors.

        ``chunk`` (control steps, default the whole horizon): the episode's
        transitions reach the host every ``chunk`` steps, ceil(h / chunk)
        times in all. Chunks run the same operations on the same tensors,
        so a chunked episode equals the whole one to the bit.
        """
        horizon = self.task_horizon
        if chunk is None or chunk >= horizon:
            chunk = horizon
        stream = self._episode_stream(mode)
        plan = policy.functional_plan()
        return [self._device_episode(policy, plan, mode, f"{stream}/{i}", chunk)
                for i in range(no_rollouts)]

    def _device_episode(self, policy, plan, mode: str, stream: str, chunk: int) -> Rollout:
        env, device, horizon = self.env, self.device, self.task_horizon
        # a learned model's weights as they are at the episode's start: the
        # tensors share the trained ones' storage, so they are the latest
        model_params = getattr(policy, "live_model_params", None)
        state, obs = env.reset_with_mode(Seeding.generator_for(f"{stream}/env", device), mode)
        pstate = policy.init_plan_state(env.obs_dim,
                                        Seeding.generator_for(f"{stream}/plan", device))
        has_success = env.is_success(obs, torch.zeros(env.action_dim, device=device),
                                     obs) is not None
        # one row per step: obs, next obs, action, reward, done, keep, success
        widths = (env.obs_dim, env.obs_dim, env.action_dim, 1, 1, 1, 1)
        buf = torch.zeros((horizon, sum(widths)), device=device)
        host = np.zeros(tuple(buf.shape), np.float32)
        done_before = torch.zeros((), device=device)
        zero = torch.zeros((), device=device)

        for start in range(0, horizon, chunk):
            stop = min(start + chunk, horizon)
            for t in range(start, stop):
                action, pstate = plan(pstate, obs,
                                      state if self.use_env_states else None, model_params)
                state2, obs2, rew, done = env.step(state, action)
                # a non-finite next observation or state is terminal AND its
                # own transition is invalid (the host path breaks before
                # appending it)
                blown = ~(torch.isfinite(obs2).all() & torch.isfinite(state2).all())
                blown_f = blown.to(torch.float32)
                # freeze after termination or blow-up at the last finite state
                dead = (done_before > 0) | blown
                keep = (1.0 - done_before) * (1.0 - blown_f)
                state2 = torch.where(dead, state, state2)
                obs2 = torch.where(dead, obs, obs2)
                # zeroed, not multiplied by 0: the blown step's reward may be NaN
                rew = torch.where(keep > 0, rew, zero)
                succ = env.is_success(obs, action, obs2) if has_success else zero
                done_after = torch.maximum(done_before, torch.maximum(done, blown_f))
                buf[t] = torch.cat([obs, obs2, action,
                                    torch.stack([rew, done_after, keep, succ])])
                state, obs, done_before = state2, obs2, done_after
            host[start:stop] = buf[start:stop].cpu().numpy()

        bounds = np.cumsum((0,) + widths)
        fields = {name: host[:, a:b] if i < 3 else host[:, a]  # vectors, then scalars
                  for i, (name, a, b) in enumerate(zip(_FIELDS, bounds[:-1], bounds[1:]))}
        t = int(fields["keep"].sum())
        rew = fields["rewards"][:t]
        if self.only_final_reward and t > 0:
            rew = np.concatenate([np.zeros(t - 1, rew.dtype), rew[-1:]])
        data = dict(observations=fields["observations"][:t],
                    next_observations=fields["next_observations"][:t],
                    actions=fields["actions"][:t], rewards=rew, dones=fields["dones"][:t])
        if has_success:
            data["successes"] = fields["successes"][:t]
        return Rollout(data=data)


def compute_reward_info(rollouts: RolloutBuffer, prefix: str = "",
                        exec_time: Optional[float] = None) -> dict:
    """Per-iteration reward metrics (reference: misc/helpers.py:212-230)."""
    info = {
        prefix + "mean_avg_reward": rollouts.mean_avg_reward,
        prefix + "mean_max_reward": rollouts.mean_max_reward,
        prefix + "mean_return": rollouts.mean_return,
        prefix + "std_return": rollouts.std_return,
    }
    if exec_time is not None:
        info[prefix + "exec_time"] = exec_time
    # final-step success per rollout; iterate (not as_array) so ragged
    # episode lengths from early termination don't break the stack
    succ = [float(r["successes"][-1]) for r in rollouts
            if "successes" in r and len(r) > 0]
    if succ:
        info[prefix + "mean_success"] = float(np.mean(succ))
        info[prefix + "std_success"] = float(np.std(succ))
    return info
