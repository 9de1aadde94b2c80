"""Ant: 3D quadruped on the spatial engine (the registry's "Ant" entry).

Counterpart of ``icem_tpu/envs/ant3d.py``: a free 6-dof torso and four legs
at 45/135/225/315 degrees, each with an azimuthal hip hinge (z-axis) and a
downward-bending ankle hinge, 8 actuators. Cost: -x_velocity + 100 *
unhealthy + ctrl cost, with x velocity from the obs[..., 0] position delta
and the healthy z band (0.2, 1.0) read at obs index 2, so the observation
keeps qpos order [x, y, z, rpy, joints] when positions are included.
``exclude_current_positions_from_observation`` drops x and y and makes the
cost and the ground-truth model raise, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.render import render_spatial_xz
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.envs.spatial_base import SpatialEnv

_AZIMUTHS = (np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4)
_HIP_R = 0.2        # hip anchor distance from torso center
_UPPER_L = 0.3      # upper-leg length (hip -> knee)
_LOWER_L = 0.45     # lower-leg length (knee -> foot center)
_FOOT_R = 0.08
_ANKLE_REF = 0.9    # stance ankle bend (rad); foot drop = LOWER_L*sin(ref)
_Z_STANCE = _LOWER_L * np.sin(_ANKLE_REF) + _FOOT_R   # ~0.43 torso height


def make_ant3d_model(dt: float = 0.05, n_substeps: int = 20) -> SpatialModel:
    inf = np.inf
    B = 9                         # torso + 4 * (upper, lower)
    parent = [-1]
    anchor = [np.zeros(3)]
    axis = [np.array([0.0, 0.0, 1.0])]
    com = [np.zeros(3)]
    mass = [10.0]
    # torso approximated as a sphere r=0.25: I = 2/5 m r^2
    inertia = [np.full(3, 0.4 * 10.0 * 0.25**2)]
    geom_body, geom_pos, geom_radius = [0], [np.zeros(3)], [0.25]

    for i, th in enumerate(_AZIMUTHS):
        u = np.array([np.cos(th), np.sin(th), 0.0])
        a_perp = np.array([-np.sin(th), np.cos(th), 0.0])
        upper = 1 + 2 * i
        # upper leg: hinge about z at the torso edge, link along u
        parent.append(0)
        anchor.append(_HIP_R * u)
        axis.append(np.array([0.0, 0.0, 1.0]))
        com.append(0.5 * _UPPER_L * u)
        mass.append(1.5)
        inertia.append(np.full(3, 1.5 * _UPPER_L**2 / 12.0))
        # lower leg: hinge about the horizontal perpendicular at the knee;
        # positive angle rotates the distal direction downward (u x a = -z)
        parent.append(upper)
        anchor.append(_UPPER_L * u)
        axis.append(a_perp)
        com.append(0.5 * _LOWER_L * u)
        mass.append(1.0)
        inertia.append(np.full(3, 1.0 * _LOWER_L**2 / 12.0))
        # knee + foot spheres
        geom_body += [upper, upper + 1]
        geom_pos += [_UPPER_L * u, _LOWER_L * u]
        geom_radius += [0.06, _FOOT_R]

    nd = 6 + B - 1                # 14
    damping = np.zeros(nd)
    damping[6:] = [3.0, 3.0] * 4
    stiffness = np.zeros(nd)
    stiffness[6:] = [60.0, 60.0] * 4
    springref = np.zeros(nd)
    springref[7::2] = _ANKLE_REF  # ankles rest bent (standing pose)
    limit_lo = np.full(nd, -inf)
    limit_hi = np.full(nd, inf)
    limit_lo[6::2], limit_hi[6::2] = -0.6, 0.6          # hips (azimuthal)
    limit_lo[7::2], limit_hi[7::2] = 0.35, 1.4          # ankles (downward bend)

    return SpatialModel(
        parent=tuple(parent),
        anchor=np.asarray(anchor, np.float32),
        axis=np.asarray(axis, np.float32),
        com=np.asarray(com, np.float32),
        mass=np.asarray(mass, np.float32),
        inertia=np.asarray(inertia, np.float32),
        free_root=True,
        geom_body=tuple(geom_body),
        geom_pos=np.asarray(geom_pos, np.float32),
        geom_radius=np.asarray(geom_radius, np.float32),
        actuator_dof=tuple(range(6, nd)),
        gear=np.array([45.0, 60.0] * 4, np.float32),     # hip, ankle per leg
        damping=damping.astype(np.float32),
        stiffness=stiffness.astype(np.float32),
        springref=springref.astype(np.float32),
        limit_lo=limit_lo.astype(np.float32),
        limit_hi=limit_hi.astype(np.float32),
        limit_stiffness=400.0,
        limit_damping=8.0,
        contact_kp=2.0e4,
        contact_kd=150.0,
        contact_fmax=1500.0,
        friction_mu=1.0,
        friction_kt=300.0,
        max_qd=50.0,
        # the per-control-step mass matrix can inject energy under
        # adversarial joint saturation; the valve bounds a step's energy gain
        # by the actuator work
        energy_valve=True,
        dt=dt,
        n_substeps=n_substeps,
    )


class Ant3D(SpatialEnv):
    """The gym ant_v3 task on the spatial engine."""

    name = "Ant"
    nq = 14   # [x, y, z, roll, pitch, yaw, 8 joints]
    nv = 14
    dt = 0.05

    _healthy_z_range = (0.2, 1.0)
    _ctrl_cost_weight = 0.5
    _healthy_reward = 1.0

    def __init__(self, *, exclude_current_positions_from_observation: bool = True,
                 frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.exclude_current_positions = bool(exclude_current_positions_from_observation)
        n_substeps = 20 if frame_skip is None else 4 * int(frame_skip)
        self.model = make_ant3d_model(dt=self.dt, n_substeps=n_substeps)
        self.action_space = BoxSpace(low=[-1.0] * 8, high=[1.0] * 8)
        obs_dim = (self.nq - 2 if self.exclude_current_positions else self.nq) + self.nv
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim,
                                          high=[np.inf] * obs_dim)
        self.supports_state_from_obs = not self.exclude_current_positions

    # state = [q(14), qd(14)]; q[2] is the absolute torso height
    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        base = torch.zeros(14, device=generator.device)
        base[2] = _Z_STANCE + 0.05
        base[7::2] = _ANKLE_REF
        spread = torch.tensor([1.0, 1.0, 0.1, 0.1, 0.1, 0.3] + [1.0] * 8,
                              device=generator.device)
        q = base + (torch.rand(14, **kw) * 0.2 - 0.1) * spread
        qd = 0.05 * torch.randn(14, **kw)
        return torch.cat([q, qd])

    def observation(self, state):
        if self.exclude_current_positions:
            return torch.cat([state[..., 2:14], state[..., 14:]], dim=-1)
        return state

    def state_from_observation(self, observation):
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "For GT model use, set 'exclude_current_positions_from_observation': false"
            )
        return observation

    def render_frame(self, state):
        """Sagittal (x, z) wireframe projection of the 3D skeleton."""
        return render_spatial_xz(self.model, state[..., : self.nq].cpu().numpy())

    def _post_step(self, state, new_state, action):
        x_velocity = (new_state[..., 0] - state[..., 0]) / self.dt
        z = new_state[..., 2]
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
        """-x_vel + 100*unhealthy + ctrl cost; x velocity from the obs[..., 0]
        position delta."""
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "If you wanna use this cost function, set "
                "'exclude_current_positions_from_observation': false")
        unhealthy = self.are_states_unhealthy(observation)
        x_velocity = (next_obs[..., 0] - observation[..., 0]) / self.dt
        control_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        return -x_velocity + 100.0 * unhealthy + control_cost
