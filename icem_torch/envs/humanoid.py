"""The sagittal-plane humanoids on the planar engine (registry strings
``PlanarHumanoidStandup`` and ``PlanarHumanoid``).

Counterpart of ``icem_tpu/envs/humanoid.py``: a 10-body model (pelvis root,
torso and head, two leg chains, one arm chain), 12 dofs, 9 actuators on
power-limited joints (the motor speed line: available torque falls to zero
at 8 rad/s in the torque's direction).

The observation is laid out so that the reference's cost formulas hold:
qpos starts with [x, y(=0), z_absolute, ...], so HumanoidStandup's cost
-obs[..., 2] + 0.1 |a|^2 reads the height, and qvel starts at index nq, so
Humanoid's x velocity is obs[..., nq].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.ant import sagittal_qpos_qvel, sagittal_state
from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.planar_base import PlanarEnv

# body order: pelvis, torso(+head), l_thigh, l_shin, l_foot,
#             r_thigh, r_shin, r_foot, arm_upper, arm_lower
_TIPS = {
    "torso": (0.0, 0.45),        # up from pelvis
    "thigh": (0.0, -0.40),
    "shin": (0.0, -0.40),
    "foot": (0.16, -0.03),
    "arm_up": (0.0, -0.28),
    "arm_lo": (0.0, -0.26),
}
_Z0 = 0.89  # pelvis height at stance: thigh + shin + foot drop + foot radius


def make_humanoid_model(dt: float = 0.05, n_substeps: int = 20) -> PlanarModel:
    inf = np.inf
    t = _TIPS
    parent = (-1, 0, 0, 2, 3, 0, 5, 6, 1, 8)
    anchor = np.array([
        [0.0, _Z0],          # pelvis root offset
        [0.0, 0.1],          # torso on pelvis
        [0.0, -0.05],        # l_thigh at hip
        t["thigh"],          # l_shin at knee
        t["shin"],           # l_foot at ankle
        [0.0, -0.05],        # r_thigh at hip
        t["thigh"],          # r_shin
        t["shin"],           # r_foot
        [0.0, 0.40],         # arm at shoulder (on torso, near top)
        t["arm_up"],         # forearm at elbow
    ], np.float32)
    com = np.array([
        [0.0, 0.0],
        [0.0, 0.25],
        [0.0, -0.20], [0.0, -0.20], [0.08, -0.015],
        [0.0, -0.20], [0.0, -0.20], [0.08, -0.015],
        [0.0, -0.14], [0.0, -0.13],
    ], np.float32)
    masses = np.array([9.0, 14.0, 4.0, 2.5, 1.0, 4.0, 2.5, 1.0, 1.5, 1.2],
                      np.float32)
    lengths = np.array([0.2, 0.55, 0.4, 0.4, 0.19, 0.4, 0.4, 0.19, 0.28, 0.26],
                       np.float32)
    inertia = (masses * lengths**2 / 12.0).astype(np.float32)

    # geoms: feet toes/heels, knees, pelvis, torso top (head), elbow, hand
    geom_body = (4, 4, 7, 7, 3, 6, 0, 1, 9, 8)
    geom_pos = np.array([
        [0.16, -0.03], [-0.06, -0.03],      # l foot toe/heel
        [0.16, -0.03], [-0.06, -0.03],      # r foot toe/heel
        t["shin"], t["shin"],               # knees (on shins' ends)
        [0.0, 0.0],                         # pelvis
        [0.0, 0.55],                        # head (above torso tip)
        t["arm_lo"],                        # hand
        t["arm_up"],                        # elbow
    ], np.float32)
    geom_radius = np.array([0.05] * 4 + [0.05] * 2 + [0.09, 0.09, 0.04, 0.04],
                           np.float32)

    # dofs: [x, z, rot, torso, l_hip, l_knee, l_ankle, r_hip, r_knee,
    #        r_ankle, shoulder, elbow]  -> 12
    n_dof = 12
    return PlanarModel(
        parent=parent,
        anchor=anchor,
        com=com,
        mass=masses,
        inertia=inertia,
        free_root=True,
        geom_body=geom_body,
        geom_pos=geom_pos,
        geom_radius=geom_radius,
        actuator_dof=tuple(range(3, n_dof)),
        gear=np.array([100, 150, 120, 90, 150, 120, 90, 40, 40], np.float32),
        damping=np.concatenate([np.zeros(3),
                                np.full(9, 4.0)]).astype(np.float32),
        stiffness=np.concatenate([np.zeros(3),
                                  np.full(9, 8.0)]).astype(np.float32),
        springref=np.zeros(n_dof, np.float32),
        limit_lo=np.array([-inf, -inf, -inf, -0.8,
                           -2.0, -2.4, -0.8, -2.0, -2.4, -0.8,
                           -3.0, -2.6], np.float32),
        limit_hi=np.array([inf, inf, inf, 0.8,
                           0.8, 0.0, 0.8, 0.8, 0.0, 0.8,
                           1.2, 0.0], np.float32),
        limit_stiffness=600.0,
        limit_damping=10.0,
        contact_kp=1.2e4,
        contact_kd=60.0,
        contact_fmax=900.0,    # per-geom; feet pairs still carry ~4x weight
        friction_mu=1.0,
        friction_kt=250.0,
        max_qd=25.0,
        motor_omega_max=8.0,   # power-limited joints: can push up, not fly
        dt=dt,
        n_substeps=n_substeps,
    )


class _HumanoidBase(PlanarEnv):
    nq = 13   # [x, y(=0), z, rot, 9 joints]: y is a constant-zero filler so
    nv = 13   # the reference's index arithmetic (height at 2, vx at nq) holds
    dt = 0.05
    n_joints = 9

    def __init__(self, *, frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        n_substeps = 20 if frame_skip is None else 4 * int(frame_skip)
        self.model = make_humanoid_model(dt=self.dt, n_substeps=n_substeps)
        self.action_space = BoxSpace(low=[-1.0] * 9, high=[1.0] * 9)
        obs_dim = self.nq + self.nv
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim,
                                          high=[np.inf] * obs_dim)

    # engine q: [x, z_off, rot, joints(9)] (12); state = [q, qd] (24)
    def observation(self, state):
        qpos, qvel = sagittal_qpos_qvel(state[..., :12], state[..., 12:], _Z0)
        return torch.cat([qpos, qvel], dim=-1)

    def state_from_observation(self, observation):
        return sagittal_state(observation[..., : self.nq], observation[..., self.nq:], _Z0)


class HumanoidStandup(_HumanoidBase):
    """The gym humanoid_standup task, in the sagittal plane: starts lying
    supine; cost = -height + 0.1 |a|^2 on the current observation."""

    name = "HumanoidStandup"

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        q = torch.zeros(12, device=generator.device)
        # supine: rotated backward, pelvis near the ground, legs slightly bent
        q[1] = 0.12 - _Z0      # z offset: pelvis at ~0.12 abs
        q[2] = -math.pi / 2 + 0.05
        q = q + 0.01 * (torch.rand(12, **kw) * 2.0 - 1.0)
        qd = 0.01 * torch.randn(12, **kw)
        return torch.cat([q, qd])

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        height = obs[..., 2]
        ctrl = 0.1 * torch.sum(torch.square(action), dim=-1)
        # the height gain rate minus the control cost
        reward = height / self.dt * 0.04 - ctrl + 1.0
        return obs, reward, torch.zeros_like(reward)

    def cost_fn(self, observation, action, next_obs):
        """-height + 0.1 |a|^2."""
        up = observation[..., 2]
        ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=-1)
        return -up + ctrl_cost


class Humanoid(_HumanoidBase):
    """The gym humanoid running task, in the sagittal plane; a terminating
    env: the step's done flag is 1 - healthy."""

    name = "Humanoid"
    _healthy_z_range = (0.6, 1.5)
    _ctrl_cost_weight = 0.1
    _forward_reward_weight = 1.25

    def __init__(self, *, exclude_current_positions_from_observation: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self._exclude_current_positions = bool(exclude_current_positions_from_observation)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        q = 0.01 * (torch.rand(12, **kw) * 2.0 - 1.0)
        qd = 0.01 * torch.randn(12, **kw)
        return torch.cat([q, qd])

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        x_vel = obs[..., self.nq]
        z = obs[..., 2]
        healthy = ((z > self._healthy_z_range[0])
                   & (z < self._healthy_z_range[1])).to(torch.float32)
        reward = (self._forward_reward_weight * x_vel + 5.0 * healthy
                  - self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1))
        return obs, reward, 1.0 - healthy

    def unhealthy_states(self, states):
        z = states[..., 2]
        healthy = (z > self._healthy_z_range[0]) & (z < self._healthy_z_range[1])
        finite = torch.all(torch.isfinite(states), dim=-1)
        return 1.0 - (healthy & finite).to(torch.float32)

    def cost_fn(self, observation, action, next_obs):
        """-w * x_vel + 100 * unhealthy + ctrl cost, the velocity read at
        index nq."""
        unhealthy = self.unhealthy_states(observation)
        x_velocity = observation[..., self.nq]
        control_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        return (-self._forward_reward_weight * x_velocity
                + 100.0 * unhealthy + control_cost)
