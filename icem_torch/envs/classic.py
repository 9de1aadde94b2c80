"""Classic-control environments: analytic dynamics, no kernel.

Counterpart of ``icem_tpu/envs/classic.py``: the gym classic-control
dynamics as state-space maps, with the same costs, goal states and masks.
Every ``step`` works over leading batch dimensions, so the population step
is the same function (``Env.step_batched``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, DiscreteSpace, Env, uniform


def angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class ContinuousPendulum(Env):
    """Torque-limited pendulum swing-up (gym Pendulum-v0 dynamics).

    Cost: angle^2 + 0.1*thdot^2 + 0.001*u^2 on the current observation.
    State: [theta, theta_dot]. Obs: [cos(theta), sin(theta), theta_dot].
    """

    name = "ContinuousPendulum"
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.action_space = BoxSpace(low=[-self.max_torque], high=[self.max_torque])
        self.observation_space = BoxSpace(low=[-1.0, -1.0, -self.max_speed],
                                          high=[1.0, 1.0, self.max_speed])

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        theta = uniform(generator, (), -math.pi, math.pi)
        theta_dot = uniform(generator, (), -1.0, 1.0)
        return torch.stack([theta, theta_dot])

    def observation(self, state):
        theta, theta_dot = state[..., 0], state[..., 1]
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)

    def step(self, state, action):
        theta, theta_dot = state[..., 0], state[..., 1]
        u = torch.clamp(action[..., 0], -self.max_torque, self.max_torque)
        cost = angle_normalize(theta) ** 2 + 0.1 * theta_dot**2 + 0.001 * u**2

        accel = 3.0 * self.g / (2.0 * self.length) * torch.sin(theta) \
            + 3.0 / (self.m * self.length**2) * u
        new_theta_dot = torch.clamp(theta_dot + accel * self.dt, -self.max_speed, self.max_speed)
        new_theta = theta + new_theta_dot * self.dt

        new_state = torch.stack([new_theta, new_theta_dot], dim=-1)
        return new_state, self.observation(new_state), -cost, torch.zeros_like(cost)

    def state_from_observation(self, observation):
        theta = torch.atan2(observation[..., 1], observation[..., 0])
        return torch.stack([theta, observation[..., 2]], dim=-1)

    def cost_fn(self, observation, action, next_obs):
        cos_t, sin_t, th_dot = observation[..., 0], observation[..., 1], observation[..., 2]
        theta = torch.atan2(sin_t, cos_t)
        act = action[..., 0]
        return angle_normalize(theta) ** 2 + 0.1 * th_dot**2 + 0.001 * act**2


class _MountainCar(Env):
    """The mountain-car track; state == observation: [position, velocity]."""

    goal_state = np.array([0.5, 0.0], np.float32)
    goal_mask = np.array([1.0, 0.0], np.float32)
    min_position, max_position = -1.2, 0.6
    max_speed = 0.07

    def get_fps(self):
        return 30.0

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        pos = uniform(generator, (), -0.6, -0.4)
        return torch.stack([pos, torch.zeros_like(pos)])

    def observation(self, state):
        return state

    def state_from_observation(self, observation):
        return observation

    def _move(self, position, velocity, push):
        velocity = velocity + push - 0.0025 * torch.cos(3.0 * position)
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(position + velocity, self.min_position, self.max_position)
        velocity = torch.where((position <= self.min_position) & (velocity < 0), 0.0, velocity)
        return position, velocity


class ContinuousMountainCar(_MountainCar):
    """Continuous mountain car (gym Continuous_MountainCarEnv dynamics).

    Cost: |position - 0.5| through the goal mask.
    """

    name = "ContinuousMountainCar"
    goal_position = 0.45
    power = 0.0015
    dt = 1.0  # steps are unit-time in the gym env

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.action_space = BoxSpace(low=[-1.0], high=[1.0])
        self.observation_space = BoxSpace(
            low=[self.min_position, -self.max_speed],
            high=[self.max_position, self.max_speed])

    def step(self, state, action):
        force = torch.clamp(action[..., 0], -1.0, 1.0)
        position, velocity = self._move(state[..., 0], state[..., 1], force * self.power)
        new_state = torch.stack([position, velocity], dim=-1)
        done = (position >= self.goal_position).to(torch.float32)
        reward = 100.0 * done - 0.1 * force**2
        return new_state, new_state, reward, done


class DiscreteActionMountainCar(_MountainCar):
    """Discrete mountain car through the continuous embedding of
    base.DiscreteSpace; gym MountainCarEnv dynamics: force = (index - 1) *
    0.001."""

    name = "DiscreteMountainCar"
    goal_position = 0.5
    force_mag = 0.001

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.action_space = DiscreteSpace(3)
        self.observation_space = BoxSpace(
            low=[self.min_position, -self.max_speed],
            high=[self.max_position, self.max_speed])

    def step(self, state, action):
        idx = self.action_space.index(action)
        position, velocity = self._move(state[..., 0], state[..., 1],
                                        (idx.to(torch.float32) - 1.0) * self.force_mag)
        new_state = torch.stack([position, velocity], dim=-1)
        done = (position >= self.goal_position).to(torch.float32)
        # gym pays -1 on EVERY step including the goal-reaching one
        return new_state, new_state, torch.full_like(position, -1.0), done


class DiscreteActionCartPole(Env):
    """Cart-pole balance (gym CartPoleEnv Euler dynamics), +-10 N discrete
    force. Cost: unmasked L2 to the zero state. State == observation:
    [x, x_dot, theta, theta_dot]."""

    name = "DiscreteCartPole"
    goal_state = np.zeros(4, np.float32)
    goal_mask = np.ones(4, np.float32)
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    pole_half_length = 0.5
    force_mag = 10.0
    dt = 0.02
    theta_threshold = 12 * 2 * np.pi / 360
    x_threshold = 2.4

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.action_space = DiscreteSpace(2)
        high = np.array([self.x_threshold * 2, np.inf, self.theta_threshold * 2, np.inf],
                        np.float32)
        self.observation_space = BoxSpace(low=-high, high=high)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        return uniform(generator, (4,), -0.05, 0.05)

    def observation(self, state):
        return state

    def step(self, state, action):
        x, x_dot, theta, theta_dot = (state[..., 0], state[..., 1], state[..., 2],
                                      state[..., 3])
        idx = self.action_space.index(action)
        force = torch.where(idx == 1, self.force_mag, -self.force_mag)

        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.pole_half_length
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_half_length * (4.0 / 3.0 - self.masspole * cos_t**2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * cos_t / total_mass

        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * x_acc
        theta = theta + self.dt * theta_dot
        theta_dot = theta_dot + self.dt * theta_acc
        new_state = torch.stack([x, x_dot, theta, theta_dot], dim=-1)

        done = ((torch.abs(x) > self.x_threshold)
                | (torch.abs(theta) > self.theta_threshold)).to(torch.float32)
        # gym pays +1 on every step, including the one where done turns True
        return new_state, new_state, torch.ones_like(x), done

    def state_from_observation(self, observation):
        return observation


class PointMass(Env):
    """2-D double integrator driven by force actions (the dm-suite
    point_mass analog). State/obs: [x, y, vx, vy]; cost = distance of (x, y)
    to the goal."""

    name = "point_mass"
    dt = 0.05
    damping = 0.5

    def __init__(self, *, goal=(0.0, 0.0), restricted_init: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.goal = np.asarray(goal, np.float32)
        self.restricted_init = restricted_init
        self.goal_state = np.array([*self.goal, 0.0, 0.0], np.float32)
        self.goal_mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        self.action_space = BoxSpace(low=[-1.0, -1.0], high=[1.0, 1.0])
        self.observation_space = BoxSpace(low=[-np.inf] * 4, high=[np.inf] * 4)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        if self.restricted_init and mode == "evaluate":
            pos = uniform(generator, (2,), 0.25, 0.3)
        else:
            pos = uniform(generator, (2,), -0.3, 0.3)
        return torch.cat([pos, torch.zeros_like(pos)])

    def observation(self, state):
        return state

    def step(self, state, action):
        pos, vel = state[..., :2], state[..., 2:]
        force = torch.clamp(action, -1.0, 1.0)
        vel = vel + self.dt * (force - self.damping * vel)
        pos = pos + self.dt * vel
        new_state = torch.cat([pos, vel], dim=-1)
        (goal,) = self._constants(state.device, self.goal)
        reward = -torch.linalg.vector_norm(pos - goal, dim=-1)
        return new_state, new_state, reward, torch.zeros_like(reward)

    def state_from_observation(self, observation):
        return observation
