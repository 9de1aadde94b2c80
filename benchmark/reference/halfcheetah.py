"""HalfCheetah running, as a plain reference task on the frozen planar engine.

State [q(9), qd(9)] with q = [rootx, rootz, rooty, 6 joints]; the
observation drops rootx (17 dims) unless the settings keep it; the step
reward is the forward velocity over the control step minus 0.1 |a|^2; the
planner's cost is the gym task's: 0.1 |a|^2 minus the velocity, plus 10
where the root angle is past pi/2 either way when flipping is penalised.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import planar_engine


class Task:
    nq = 9
    dt = 0.05
    engine = planar_engine

    def __init__(self, env_params: dict):
        self.exclude_x = bool(env_params.get("exclude_current_positions_from_observation", True))
        self.penalise_flipping = bool(env_params.get("penalise_flipping", False))
        self.forward_weight = float(env_params.get("forward_reward_weight", 1.0))
        self.ctrl_weight = float(env_params.get("ctrl_cost_weight", 0.1))
        self.model = planar_engine.make_cheetah_model(dt=self.dt, n_substeps=20)
        self.action_dim = 6
        self.low, self.high = -1.0, 1.0

    def init_state(self, gen: torch.Generator):
        kw = dict(generator=gen, device=gen.device)
        qpos = torch.rand(self.nq, **kw) * 0.2 - 0.1
        qvel = 0.1 * torch.randn(self.nq, **kw)
        return torch.cat([qpos, qvel])

    def observation(self, state):
        qpos, qvel = state[..., : self.nq], state[..., self.nq:]
        if self.exclude_x:
            qpos = qpos[..., 1:]
        return torch.cat([qpos, qvel], dim=-1)

    def reward(self, state, new_state, action):
        x_velocity = (new_state[..., 0] - state[..., 0]) / self.dt
        ctrl_cost = self.ctrl_weight * torch.sum(torch.square(action), dim=-1)
        return self.forward_weight * x_velocity - ctrl_cost

    def cost(self, obs, action, next_obs):
        d = obs.shape[-1]
        root_angle = obs[..., 2] if d == 18 else obs[..., 1]
        velocity = obs[..., 9] if d == 18 else obs[..., 8]
        scores = torch.zeros(action.shape[:-1], dtype=action.dtype, device=action.device)
        if self.penalise_flipping:
            scores = scores + (root_angle > math.pi / 2) * 10.0
            scores = scores + (root_angle < -math.pi / 2) * 10.0
        scores = scores + 0.1 * torch.sum(action**2, dim=-1)
        return scores - velocity
