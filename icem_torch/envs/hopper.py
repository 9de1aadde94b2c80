"""Hopper: planar one-legged hopper on the planar engine.

Counterpart of ``icem_tpu/envs/hopper.py``:

- 6 dofs [rootx, rootz, rooty, thigh, leg, foot], 3 torque actuators
- observation = [qpos (optionally excluding rootx), qvel] -> 11 or 12 dims
- batched cost_fn: -x_velocity + 200 * unhealthy + ctrl_cost, where
  "unhealthy" combines the healthy state, height and angle ranges
- a terminating env: the step's done flag is 1 - healthy
- ground-truth state = [qpos, qvel]; the cost needs 12-dim observations
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.planar_base import PlanarEnv


def make_hopper_model(dt: float = 0.05, n_substeps: int = 20) -> PlanarModel:
    z0 = 1.2  # root (torso center) height at stance
    inf = np.inf
    masses = np.array([3.66, 4.06, 2.78, 3.2], np.float32)
    # torso vertical (root at center), thigh/leg vertical, foot horizontal
    tips = {
        "thigh": (0.0, -0.45),
        "leg": (0.0, -0.50),
        "foot": (0.26, -0.04),
    }
    lengths = np.array([0.4, 0.45, 0.5, 0.39], np.float32)
    inertia = (masses * lengths**2 / 12.0).astype(np.float32)

    anchor = np.array([
        [0.0, z0],
        [0.0, -0.2],        # hip at torso bottom
        tips["thigh"],      # knee
        tips["leg"],        # ankle
    ], np.float32)
    com = np.array([
        [0.0, 0.0],
        [0.0, -0.225],
        [0.0, -0.25],
        [0.065, -0.02],
    ], np.float32)

    geom_body = (3, 3, 0)
    geom_pos = np.array([
        [0.26, -0.04],      # toe
        [-0.13, -0.04],     # heel
        [0.0, 0.2],         # torso top (fall protection)
    ], np.float32)
    geom_radius = np.array([0.046, 0.046, 0.05], np.float32)

    return PlanarModel(
        parent=(-1, 0, 1, 2),
        anchor=anchor,
        com=com,
        mass=masses,
        inertia=inertia,
        free_root=True,
        geom_body=geom_body,
        geom_pos=geom_pos,
        geom_radius=geom_radius,
        actuator_dof=(3, 4, 5),
        gear=np.array([200.0, 200.0, 200.0], np.float32),
        damping=np.array([0, 0, 0, 1.0, 1.0, 1.0], np.float32),
        stiffness=np.zeros(6, np.float32),
        springref=np.zeros(6, np.float32),
        limit_lo=np.array([-inf, -inf, -inf, -2.62, -2.62, -0.785], np.float32),
        limit_hi=np.array([inf, inf, inf, 0.0, 0.0, 0.785], np.float32),
        limit_stiffness=500.0,
        limit_damping=8.0,
        contact_kp=1.2e4,
        contact_kd=50.0,
        contact_fmax=1500.0,   # ~11x body weight
        friction_mu=1.0,
        friction_kt=200.0,
        max_qd=50.0,
        dt=dt,
        n_substeps=n_substeps,
    )


class Hopper(PlanarEnv):
    """The gym hopper task on the planar engine."""

    name = "Hopper"
    nq = 6
    nv = 6
    dt = 0.05

    _healthy_state_range = (-100.0, 100.0)
    _healthy_z_range = (0.7, np.inf)
    _healthy_angle_range = (-0.2, 0.2)
    _ctrl_cost_weight = 1e-3

    def __init__(self, *, exclude_current_positions_from_observation: bool = True,
                 frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.exclude_current_positions = bool(exclude_current_positions_from_observation)
        n_substeps = 20 if frame_skip is None else 5 * int(frame_skip)
        self.model = make_hopper_model(dt=self.dt, n_substeps=n_substeps)
        self.action_space = BoxSpace(low=[-1.0] * 3, high=[1.0] * 3)
        obs_dim = (self.nq - 1 if self.exclude_current_positions else self.nq) + self.nv
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim, high=[np.inf] * obs_dim)
        self.supports_state_from_obs = not self.exclude_current_positions

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        qpos = torch.rand(self.nq, **kw) * 1e-2 - 5e-3
        qvel = torch.rand(self.nv, **kw) * 1e-2 - 5e-3
        return torch.cat([qpos, qvel])

    def observation(self, state):
        qpos, qvel = state[..., : self.nq], state[..., self.nq:]
        if self.exclude_current_positions:
            qpos = qpos[..., 1:]
        return torch.cat([qpos, qvel], dim=-1)

    def state_from_observation(self, observation):
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "For GT model use, set 'exclude_current_positions_from_observation': false"
            )
        return observation

    def _absolute_z(self, qpos_z):
        """Engine z is an offset from the stance height z0 = 1.2."""
        return qpos_z + 1.2

    def _healthy(self, z, angle, rest):
        """Every entry of ``rest`` inside the state range, the height above
        its floor, the torso angle inside its range: a bool tensor."""
        lo, hi = self._healthy_state_range
        healthy_state = torch.all((rest > lo) & (rest < hi), dim=-1)
        healthy_z = z > self._healthy_z_range[0]
        healthy_angle = (angle > self._healthy_angle_range[0]) & \
                        (angle < self._healthy_angle_range[1])
        return healthy_state & healthy_z & healthy_angle

    def _post_step(self, state, new_state, action):
        x_velocity = (new_state[..., 0] - state[..., 0]) / self.dt
        healthy = self._is_healthy(new_state[..., : self.nq], new_state[..., self.nq:])
        reward = x_velocity + 1.0 * healthy \
            - self._ctrl_cost_weight * torch.sum(action**2, dim=-1)
        return self.observation(new_state), reward, 1.0 - healthy

    def _is_healthy(self, qpos, qvel):
        """1.0 where the hopper is healthy, else 0.0."""
        rest = torch.cat([qpos[..., 2:], qvel], dim=-1)
        return self._healthy(self._absolute_z(qpos[..., 1]), qpos[..., 2],
                             rest).to(torch.float32)

    def unhealthy_states(self, states):
        """Batched unhealthy flag over 12-dim observations."""
        finite = torch.all(torch.isfinite(states), dim=-1)
        healthy = self._healthy(self._absolute_z(states[..., 1]), states[..., 2],
                                states[..., 2:])
        return 1.0 - (finite & healthy).to(torch.float32)

    def cost_fn(self, observation, action, next_obs):
        if observation.shape[-1] != 12:
            raise AttributeError(
                "If you wanna use this cost function, set "
                "'exclude_current_positions_from_observation': false")
        x_velocity = (next_obs[..., 0] - observation[..., 0]) / self.dt
        control_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        unhealthy = self.unhealthy_states(observation)
        return -x_velocity + 200.0 * unhealthy + control_cost
