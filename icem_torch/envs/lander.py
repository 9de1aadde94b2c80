"""Continuous lunar lander: analytic dynamics, no kernel.

Counterpart of ``icem_tpu/envs/lander.py``: a rigid-body lander with main and
side thrusters, gravity and leg ground contact.

Obs (8) = [x, y, vx, vy, angle, angular_vel, leg1_contact, leg2_contact].
Action (2) = [main_throttle, side_throttle] in [-1, 1]; the main engine
fires only for throttle > 0, the side engines for |side| > 0.5, as in gym's
continuous lander. The default cost is the masked L2 distance to
goal_state [0, 0, 0, 0, 0, 0, 1, 1] with the legs masked out. ``step``
works over leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, Env, uniform


class ContinuousLunarLander(Env):
    name = "ContinuousLunarLander"
    goal_state = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    goal_mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    dt = 0.02  # 50 fps
    gravity = 1.625  # in scaled viewport units like the original
    main_power = 4.0
    side_power = 0.6
    leg_span = 0.12

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.action_space = BoxSpace(low=[-1.0, -1.0], high=[1.0, 1.0])
        self.observation_space = BoxSpace(low=[-np.inf] * 8, high=[np.inf] * 8)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        x = uniform(generator, (), -0.2, 0.2)
        fx = uniform(generator, (2,), -0.3, 0.3)
        zero = torch.zeros_like(x)
        # [x, y, vx, vy, angle, omega]
        return torch.stack([x, zero + 1.4, fx[0], zero, fx[1] * 0.2, zero])

    def _legs(self, state):
        y, ang = state[..., 1], state[..., 4]
        leg_y = y - 0.1 * torch.cos(ang)
        l1 = leg_y - self.leg_span * torch.sin(ang) <= 0.0
        l2 = leg_y + self.leg_span * torch.sin(ang) <= 0.0
        return l1.to(torch.float32), l2.to(torch.float32)

    def observation(self, state):
        l1, l2 = self._legs(state)
        return torch.cat([state, l1[..., None], l2[..., None]], dim=-1)

    def step(self, state, action):
        x, y, vx, vy, ang, omega = (state[..., i] for i in range(6))
        a = torch.clamp(action, -1.0, 1.0)
        a0, a1 = a[..., 0], a[..., 1]
        # gym semantics: main fires for a[0] > 0 at 50-100% power
        main = torch.where(a0 > 0.0, 0.5 + 0.5 * torch.clamp(a0, 0.0, 1.0), 0.0)
        side = torch.where(torch.abs(a1) > 0.5, torch.sign(a1)
                           * (0.5 + 0.5 * (torch.abs(a1) - 0.5) * 2), 0.0)

        thrust_x = -torch.sin(ang) * main * self.main_power
        thrust_y = torch.cos(ang) * main * self.main_power

        on_ground = y <= 0.1
        vx = vx + self.dt * thrust_x
        vy = vy + self.dt * (thrust_y - self.gravity)
        omega = omega + self.dt * side * self.side_power * 10.0
        # classify on the impact velocity, before ground damping rewrites it:
        # a hard vertical slam is a crash, not a +10 landing
        vy_impact = vy
        # ground contact: support + strong damping
        vy = torch.where(on_ground & (vy < 0), -0.2 * vy, vy)
        vx = torch.where(on_ground, vx * 0.8, vx)
        omega = torch.where(on_ground, omega * 0.8, omega)

        x = x + self.dt * vx
        y = torch.clamp(y + self.dt * vy, min=0.1)
        ang = ang + self.dt * omega
        new_state = torch.stack([x, y, vx, vy, ang, omega], dim=-1)
        obs = self.observation(new_state)

        landed = on_ground & (torch.abs(vx) < 0.1) & (torch.abs(ang) < 0.2) \
            & (torch.abs(x) < 0.2) & (torch.abs(vy_impact) < 1.0)
        crashed = on_ground & ((torch.abs(ang) > 0.6) | (torch.abs(vy_impact) > 1.0))
        shaping = -(torch.abs(x) + torch.abs(y) + 0.3 * (torch.abs(vx) + torch.abs(vy))
                    + torch.abs(ang))
        reward = shaping - 0.3 * main - 0.03 * torch.abs(side) \
            + 10.0 * landed.to(torch.float32)
        done = (landed | crashed).to(torch.float32)
        return new_state, obs, reward, done

    def state_from_observation(self, observation):
        return observation[..., :6]
