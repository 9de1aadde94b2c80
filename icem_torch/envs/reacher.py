"""Reacher: 2-link planar arm reaching a random target.

Counterpart of ``icem_tpu/envs/reacher.py``, on the planar engine with a
fixed base and no gravity (the arm moves in the horizontal plane): a hinge
root, no contact geoms.

- ``Reacher`` (gym flavor): observation (11) = [cos q1, cos q2, sin q1,
  sin q2, target_xy (2), qvel (2), fingertip - target (3, z term always 0)];
  cost = |fingertip - target| from the observation tail;
  state_from_observation recovers the angles by atan2
- ``ReacherSuite`` (dm-suite flavor): observation (6) = [q1, q2,
  to_target_xy (2), qvel (2)]; cost = |to_target|
- ``RestrictedReacherSuite``: mode-dependent init around a fixed goal
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, uniform
from icem_torch.envs.physics.planar import PlanarModel, chain_link_inertia
from icem_torch.envs.planar_base import PlanarEnv


def make_arm_model(l1: float, l2: float, dt: float, n_substeps: int,
                   torque: float, damping: float) -> PlanarModel:
    m1, m2 = 0.1, 0.1
    inf = np.inf
    return PlanarModel(
        parent=(-1, 0),
        anchor=np.array([[0.0, 0.0], [l1, 0.0]], np.float32),
        com=np.array([[l1 / 2, 0.0], [l2 / 2, 0.0]], np.float32),
        mass=np.array([m1, m2], np.float32),
        inertia=np.array([chain_link_inertia(m1, l1),
                          chain_link_inertia(m2, l2)], np.float32),
        free_root=False,
        actuator_dof=(0, 1),
        gear=np.array([torque, torque], np.float32),
        damping=np.array([damping, damping], np.float32),
        stiffness=np.zeros(2, np.float32),
        springref=np.zeros(2, np.float32),
        limit_lo=np.array([-inf, -3.0], np.float32),
        limit_hi=np.array([inf, 3.0], np.float32),
        gravity=0.0,   # horizontal plane
        dt=dt,
        n_substeps=n_substeps,
    )


class TwoLinkArm(PlanarEnv):
    """Shared dynamics. State = [q1, q2, qd1, qd2, target_x, target_y]."""

    l1 = 0.1
    l2 = 0.11
    dt = 0.02
    torque = 0.05
    joint_damping = 0.01
    target_radius_range = (0.05, 0.20)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model = make_arm_model(self.l1, self.l2, self.dt, 4,
                                    self.torque, self.joint_damping)
        self.action_space = BoxSpace(low=[-1.0, -1.0], high=[1.0, 1.0])

    def fingertip(self, q):
        x = self.l1 * torch.cos(q[..., 0]) + self.l2 * torch.cos(q[..., 0] + q[..., 1])
        y = self.l1 * torch.sin(q[..., 0]) + self.l2 * torch.sin(q[..., 0] + q[..., 1])
        return torch.stack([x, y], dim=-1)

    def _sample_target(self, generator: torch.Generator):
        angle = uniform(generator, (), 0.0, 2 * math.pi)
        radius = uniform(generator, (), *self.target_radius_range)
        return torch.stack([radius * torch.sin(angle), radius * torch.cos(angle)])


class Reacher(TwoLinkArm):
    """The gym reacher task."""

    name = "Reacher"

    def __init__(self, *, frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.observation_space = BoxSpace(low=[-np.inf] * 11, high=[np.inf] * 11)
        self.supports_state_from_obs = True

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        q = uniform(generator, (2,), -0.1, 0.1)
        qd = uniform(generator, (2,), -0.005, 0.005)
        target = self._sample_target(generator)
        return torch.cat([q, qd, target])

    def observation(self, state):
        q, qd, target = state[..., :2], state[..., 2:4], state[..., 4:6]
        diff = self.fingertip(q) - target
        return torch.cat([torch.cos(q), torch.sin(q), target, qd, diff,
                          torch.zeros_like(diff[..., :1])], dim=-1)

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        dist = torch.linalg.vector_norm(obs[..., -3:], dim=-1)
        reward = -dist - torch.sum(torch.square(action), dim=-1)
        return obs, reward, torch.zeros_like(reward)

    def state_from_observation(self, observation):
        theta1 = torch.atan2(observation[..., 2], observation[..., 0])
        theta2 = torch.atan2(observation[..., 3], observation[..., 1])
        return torch.cat([
            torch.stack([theta1, theta2], dim=-1),
            observation[..., 6:8],
            observation[..., 4:6],
        ], dim=-1)

    def cost_fn(self, observations, actions, next_observations):
        return torch.linalg.vector_norm(observations[..., -3:], dim=-1)


class ReacherSuite(TwoLinkArm):
    """The dm-suite reacher flavor: observation (6) = [q1, q2, to_target_xy
    (2), qvel (2)]; cost = |to_target| read from obs[..., 2:4]."""

    name = "reacher"

    def __init__(self, *, task_name: str = "easy", task_kwargs=None, **kwargs):
        kwargs.pop("visualize_reward", None)
        kwargs.pop("render_mode", None)
        super().__init__(**kwargs)
        self.task_name = task_name
        self.observation_space = BoxSpace(low=[-np.inf] * 6, high=[np.inf] * 6)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        q = uniform(generator, (2,), -math.pi, math.pi)
        target = self._sample_target(generator)
        return torch.cat([q, torch.zeros_like(q), target])

    def observation(self, state):
        q, qd, target = state[..., :2], state[..., 2:4], state[..., 4:6]
        to_target = target - self.fingertip(q)
        return torch.cat([q, to_target, qd], dim=-1)

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        dist = torch.linalg.vector_norm(obs[..., 2:4], dim=-1)
        return obs, -dist, torch.zeros_like(dist)

    def cost_fn(self, states, actions, next_states):
        return torch.linalg.vector_norm(states[..., 2:4], dim=-1)

    def state_from_observation(self, observation):
        q = observation[..., :2]
        qd = observation[..., 4:6]
        target = self.fingertip(q) + observation[..., 2:4]
        return torch.cat([q, qd, target], dim=-1)


class RestrictedReacherSuite(ReacherSuite):
    """Mode-dependent init randomization around a fixed goal."""

    name = "restricted_reacher"

    def __init__(self, *, goal_xcoor=-0.15, goal_ycoor=-0.1,
                 init_position_std_train=0.05, init_position_std_eval=0.1, **kwargs):
        super().__init__(**kwargs)
        self.goal = np.array([goal_xcoor, goal_ycoor], np.float32)
        self.init_position_std_train = float(init_position_std_train)
        self.init_position_std_eval = float(init_position_std_eval)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        # the JAX package's choice, kept: evaluation draws with the eval std
        # (the reference swaps the two lookups), around a fixed base pose
        std = self.init_position_std_eval if mode == "evaluate" \
            else self.init_position_std_train
        q = 1.0 + uniform(generator, (2,), -std, std)
        goal = torch.as_tensor(self.goal, device=q.device)
        return torch.cat([q, torch.zeros_like(q), goal])
