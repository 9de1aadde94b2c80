"""HumanoidStandup, as a plain reference task on the frozen spatial engine.

State [q(23), qd(23)] with q = [x, y, z, roll, pitch, yaw, 17 joints] and
the root chart recentred by -pi/4 in pitch; the episode starts supine with
both knees bent; the observation is the state unless the settings drop x
and y; the step reward is 0.04 height / dt - 0.1 |a|^2 + 1, and the
planner's cost -height + 0.1 |a|^2 on the current observation.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import spatial_engine


class Task:
    nq = 23
    dt = 0.05
    engine = spatial_engine

    def __init__(self, env_params: dict):
        self.exclude_xy = bool(env_params.get("exclude_current_positions_from_observation", False))
        self.model = spatial_engine.make_humanoid3d_model(
            dt=self.dt, n_substeps=20, chart_center_pitch=-np.pi / 4)
        self.action_dim = 17
        self.low, self.high = -1.0, 1.0

    def init_state(self, gen: torch.Generator):
        kw = dict(generator=gen, device=gen.device)
        q = torch.zeros(self.nq, device=gen.device)
        q[2] = 0.16
        q[4] = -np.pi / 4
        q[12] = 0.4
        q[16] = 0.4
        q = q + 0.01 * (torch.rand(self.nq, **kw) * 2.0 - 1.0)
        qd = 0.01 * torch.randn(self.nq, **kw)
        return torch.cat([q, qd])

    def observation(self, state):
        if self.exclude_xy:
            return torch.cat([state[..., 2:self.nq], state[..., self.nq:]], dim=-1)
        return state

    def reward(self, state, new_state, action):
        ctrl = 0.1 * torch.sum(torch.square(action), dim=-1)
        return new_state[..., 2] / self.dt * 0.04 - ctrl + 1.0

    def cost(self, obs, action, next_obs):
        up = obs[..., 0 if self.exclude_xy else 2]
        return -up + 0.1 * torch.sum(torch.square(action), dim=-1)
