"""Ant: the sagittal-plane quadruped on the planar engine (registry string
``PlanarAnt``).

Counterpart of ``icem_tpu/envs/ant.py``: a torso with a back and a front leg
chain (hip + ankle each, 4 actuators, each leg carrying doubled mass and
strength for a lateral pair).

- batched cost_fn: -x_velocity + 100 * unhealthy + ctrl_cost, with x_velocity
  the finite difference (next_obs[..., 0] - obs[..., 0]) / dt and
  "unhealthy" 1 - finite(states) * (z in the healthy range), z at
  observation index 2
- a terminating env: the step's done flag is 1 - healthy
- qpos = [x, y(=0), z_absolute, rot, 4 joint angles], so x sits at index 0
  and the height at index 2; qvel mirrors it
- ground-truth state = [q, qd] of the engine (14); the cost needs the
  position-included observation
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.planar_base import PlanarEnv

_Z0 = 0.62  # torso center height at stance (feet barely touch at q=0)


def make_ant_model(dt: float = 0.05, n_substeps: int = 20) -> PlanarModel:
    inf = np.inf
    # bodies: torso(0), b_thigh(1), b_foot(2), f_thigh(3), f_foot(4)
    tips = {
        "b_thigh": (-0.10, -0.14),
        "b_foot": (-0.02, -0.36),
        "f_thigh": (0.10, -0.14),
        "f_foot": (0.02, -0.36),
    }
    anchor = np.array([
        [0.0, _Z0],          # root offset
        [-0.20, -0.05],      # back hip on torso
        tips["b_thigh"],     # back ankle
        [0.20, -0.05],       # front hip
        tips["f_thigh"],     # front ankle
    ], np.float32)
    com = np.array([
        [0.0, 0.0],
        [-0.07, -0.05], [-0.05, -0.18],
        [0.07, -0.05], [0.05, -0.18],
    ], np.float32)
    # each planar leg stands in for a lateral pair -> doubled mass
    masses = np.array([10.0, 3.0, 2.0, 3.0, 2.0], np.float32)
    lengths = np.array([0.5, 0.17, 0.37, 0.17, 0.37], np.float32)
    inertia = (masses * lengths**2 / 12.0).astype(np.float32)

    geom_body = (2, 4, 0, 0, 1, 3)
    geom_pos = np.array([
        tips["b_foot"], tips["f_foot"],        # feet
        [-0.25, 0.0], [0.25, 0.0],             # torso ends (fall protection)
        tips["b_thigh"], tips["f_thigh"],      # knees
    ], np.float32)
    geom_radius = np.array([0.08, 0.08, 0.12, 0.12, 0.06, 0.06], np.float32)

    # dofs: [x, z, rot, b_hip, b_ankle, f_hip, f_ankle]
    return PlanarModel(
        parent=(-1, 0, 1, 0, 3),
        anchor=anchor,
        com=com,
        mass=masses,
        inertia=inertia,
        free_root=True,
        geom_body=geom_body,
        geom_pos=geom_pos,
        geom_radius=geom_radius,
        actuator_dof=(3, 4, 5, 6),
        gear=np.array([90.0, 70.0, 90.0, 70.0], np.float32),
        damping=np.array([0, 0, 0, 4.0, 3.0, 4.0, 3.0], np.float32),
        stiffness=np.array([0, 0, 0, 120.0, 90.0, 120.0, 90.0], np.float32),
        springref=np.zeros(7, np.float32),
        limit_lo=np.array([-inf, -inf, -inf, -0.7, -0.9, -0.7, -0.9], np.float32),
        limit_hi=np.array([inf, inf, inf, 0.7, 0.9, 0.7, 0.9], np.float32),
        limit_stiffness=500.0,
        limit_damping=8.0,
        contact_kp=1.2e4,
        contact_kd=60.0,
        contact_fmax=1200.0,
        friction_mu=1.2,
        friction_kt=220.0,
        max_qd=40.0,
        dt=dt,
        n_substeps=n_substeps,
    )


def sagittal_qpos_qvel(q, qd, z0: float):
    """Engine [x, z_offset, rot, joints] -> qpos [x, 0, z_absolute, rot,
    joints] and qvel [vx, 0, vz, rot rate, joint rates]."""
    zeros = torch.zeros_like(q[..., :1])
    qpos = torch.cat([q[..., 0:1], zeros, q[..., 1:2] + z0, q[..., 2:]], dim=-1)
    qvel = torch.cat([qd[..., 0:1], zeros, qd[..., 1:2], qd[..., 2:]], dim=-1)
    return qpos, qvel


def sagittal_state(qpos, qvel, z0: float):
    """The inverse of ``sagittal_qpos_qvel``: the engine state [q, qd]."""
    q = torch.cat([qpos[..., 0:1], qpos[..., 2:3] - z0, qpos[..., 3:]], dim=-1)
    qd = torch.cat([qvel[..., 0:1], qvel[..., 2:3], qvel[..., 3:]], dim=-1)
    return torch.cat([q, qd], dim=-1)


class Ant(PlanarEnv):
    """The gym ant task, in the sagittal plane."""

    name = "Ant"
    nq = 8   # [x, y(=0), z_abs, rot, 4 joints]; y is a constant-zero filler
    nv = 8   # so the reference's index arithmetic (x at 0, z at 2) holds
    dt = 0.05

    _healthy_z_range = (0.2, 1.0)
    _ctrl_cost_weight = 0.5
    _healthy_reward = 1.0

    def __init__(self, *, exclude_current_positions_from_observation: bool = True,
                 frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.exclude_current_positions = bool(exclude_current_positions_from_observation)
        n_substeps = 20 if frame_skip is None else 4 * int(frame_skip)
        self.model = make_ant_model(dt=self.dt, n_substeps=n_substeps)
        self.action_space = BoxSpace(low=[-1.0] * 4, high=[1.0] * 4)
        obs_dim = (self.nq - 2 if self.exclude_current_positions else self.nq) + self.nv
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim,
                                          high=[np.inf] * obs_dim)
        self.supports_state_from_obs = not self.exclude_current_positions

    # engine q: [x, z_off, rot, joints(4)] (7); state = [q, qd] (14)
    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        scale = torch.tensor([1.0, 0.1, 0.3, 1.0, 1.0, 1.0, 1.0], device=generator.device)
        q = (torch.rand(7, **kw) * 0.2 - 0.1) * scale
        qd = 0.05 * torch.randn(7, **kw)
        return torch.cat([q, qd])

    def observation(self, state):
        qpos, qvel = sagittal_qpos_qvel(state[..., :7], state[..., 7:], _Z0)
        if self.exclude_current_positions:
            qpos = qpos[..., 2:]  # gym drops x AND y
        return torch.cat([qpos, qvel], dim=-1)

    def state_from_observation(self, observation):
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "For GT model use, set 'exclude_current_positions_from_observation': false"
            )
        return sagittal_state(observation[..., : self.nq], observation[..., self.nq:], _Z0)

    def _post_step(self, state, new_state, action):
        x_velocity = (new_state[..., 0] - state[..., 0]) / self.dt
        z = new_state[..., 1] + _Z0
        healthy = ((z >= self._healthy_z_range[0])
                   & (z <= self._healthy_z_range[1])).to(torch.float32)
        reward = (x_velocity + self._healthy_reward * healthy
                  - self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1))
        return self.observation(new_state), reward, 1.0 - healthy

    def are_states_unhealthy(self, states):
        """Batched unhealthy flag over position-included observations."""
        min_z, max_z = self._healthy_z_range
        finite = torch.all(torch.isfinite(states), dim=-1)
        in_range = (states[..., 2] >= min_z) & (states[..., 2] <= max_z)
        return 1.0 - (finite & in_range).to(torch.float32)

    def cost_fn(self, observation, action, next_obs):
        """-x_vel + 100 * unhealthy + ctrl cost; x velocity from the
        obs[..., 0] position delta."""
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "If you wanna use this cost function, set "
                "'exclude_current_positions_from_observation': false")
        unhealthy = self.are_states_unhealthy(observation)
        x_velocity = (next_obs[..., 0] - observation[..., 0]) / self.dt
        control_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        return -x_velocity + 100.0 * unhealthy + control_cost
