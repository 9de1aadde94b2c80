"""Humanoid: 3D biped on the spatial engine.

Counterpart of ``icem_tpu/envs/humanoid3d.py``: a free 6-dof torso root, a
3-dof abdomen (z/y/x stacked hinges), two legs with 3-dof hips (x/z/y) +
knee, and two arms with 2-dof shoulders + elbow: 17 actuators. A k-dof joint
is k stacked hinges through near-massless intermediate bodies.

Costs are the reference's formulas:
- HumanoidStandup: cost = -obs[..., 2] + 0.1*|a|^2 (height on the current
  observation);
- Humanoid: cost = -1.25 * x_vel + 100 * unhealthy + 0.1*|a|^2, with x
  velocity at obs index nq (or nq-2 with positions excluded) and the healthy
  band (1.0, 2.0) on z.

Observation = [qpos(23), qvel(23)], qpos = [x, y, z, roll, pitch, yaw, 17
joint angles] with z the absolute torso height. HumanoidStandup recentres
the root chart by Ry(-pi/4) (``root_rot_offset``), so that supine (chart
pitch -pi/4) and upright (+pi/4) both sit far from the chart's singularity
at pitch +-pi/2.
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.render import render_spatial_xz
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.envs.spatial_base import SpatialEnv

_TINY_MASS = 0.05
_THIGH_L = 0.45
_SHIN_L = 0.45
_FOOT_R = 0.08
_HIP_DROP = 0.32          # torso center -> hip anchor vertical drop
_HIP_Y = 0.10             # lateral hip offset
_UPPER_ARM_L = 0.28
_LOWER_ARM_L = 0.26
_Z_STANCE = _THIGH_L + _SHIN_L + _FOOT_R + _HIP_DROP    # ~1.30 torso height

# dof layout (after the 6 root dofs), one actuator each:
# [ab_z, ab_y, ab_x,
#  r_hip_x, r_hip_z, r_hip_y, r_knee, l_hip_x, l_hip_z, l_hip_y, l_knee,
#  r_sh_x, r_sh_y, r_elbow, l_sh_x, l_sh_y, l_elbow]
_N_JOINTS = 17

_X = np.array([1.0, 0.0, 0.0])
_Y = np.array([0.0, 1.0, 0.0])
_Z = np.array([0.0, 0.0, 1.0])


def make_humanoid3d_model(dt: float = 0.05, n_substeps: int = 20,
                          chart_center_pitch: float = 0.0) -> SpatialModel:
    """chart_center_pitch rotates the root rpy chart: world R = Ry(center)
    @ R_rpy(q[3:6])."""
    inf = np.inf
    z3 = np.zeros(3)
    tiny_inertia = np.full(3, 1e-4)

    # body 0: torso (root). Geoms: chest sphere + head sphere.
    parent = [-1]
    anchor = [z3]
    axis = [_Z]                     # unused for the free root
    com = [np.array([0.0, 0.0, 0.05])]
    mass = [8.0]
    inertia = [np.full(3, 0.4 * 8.0 * 0.16**2)]
    geom_body = [0, 0]
    geom_pos = [np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.28])]
    geom_radius = [0.14, 0.10]

    def add_body(par, anc, ax, com_, m, I3, geoms=()):
        parent.append(par)
        anchor.append(np.asarray(anc, np.float64))
        axis.append(np.asarray(ax, np.float64))
        com.append(np.asarray(com_, np.float64))
        mass.append(m)
        inertia.append(np.asarray(I3, np.float64))
        b = len(parent) - 1
        for gpos, gr in geoms:
            geom_body.append(b)
            geom_pos.append(np.asarray(gpos, np.float64))
            geom_radius.append(gr)
        return b

    def rod_inertia(m, L):
        return np.full(3, m * L**2 / 12.0)

    # abdomen chain torso -> pelvis: hinge z, hinge y, hinge x
    ab1 = add_body(0, [0.0, 0.0, -0.20], _Z, z3, _TINY_MASS, tiny_inertia)
    ab2 = add_body(ab1, z3, _Y, z3, _TINY_MASS, tiny_inertia)
    pelvis = add_body(ab2, [0.0, 0.0, -0.12], _X, [0.0, 0.0, -0.02], 9.0,
                      np.full(3, 0.4 * 9.0 * 0.12**2),
                      geoms=[([0.0, 0.0, -0.02], 0.12)])

    legs = []
    for side in (-1.0, +1.0):       # right (y<0), left (y>0)
        hip_anchor = np.array([0.0, side * _HIP_Y, 0.0])
        h1 = add_body(pelvis, hip_anchor, _X, z3, _TINY_MASS, tiny_inertia)
        h2 = add_body(h1, z3, _Z, z3, _TINY_MASS, tiny_inertia)
        thigh = add_body(h2, z3, _Y, [0.0, 0.0, -_THIGH_L / 2], 4.5,
                         rod_inertia(4.5, _THIGH_L),
                         geoms=[([0.0, 0.0, -_THIGH_L], 0.06)])
        shin = add_body(thigh, [0.0, 0.0, -_THIGH_L], _Y,
                        [0.0, 0.0, -_SHIN_L / 2], 2.8,
                        rod_inertia(2.8, _SHIN_L),
                        # heel + toe spheres give a pitch-stable foot
                        geoms=[([-0.03, 0.0, -_SHIN_L], _FOOT_R),
                               ([0.13, 0.0, -_SHIN_L + 0.01], 0.07)])
        legs.append((h1, h2, thigh, shin))

    arms = []
    for side in (-1.0, +1.0):
        sh_anchor = np.array([0.0, side * 0.18, 0.17])
        s1 = add_body(0, sh_anchor, _X, z3, _TINY_MASS, tiny_inertia)
        upper = add_body(s1, z3, _Y, [0.0, 0.0, -_UPPER_ARM_L / 2], 1.6,
                         rod_inertia(1.6, _UPPER_ARM_L),
                         geoms=[([0.0, 0.0, -_UPPER_ARM_L], 0.04)])
        lower = add_body(upper, [0.0, 0.0, -_UPPER_ARM_L], _Y,
                         [0.0, 0.0, -_LOWER_ARM_L / 2], 1.2,
                         rod_inertia(1.2, _LOWER_ARM_L),
                         geoms=[([0.0, 0.0, -_LOWER_ARM_L], 0.045)])
        arms.append((s1, upper, lower))

    B = len(parent)                 # 18
    nd = 6 + B - 1                  # 23
    assert nd == 6 + _N_JOINTS

    # per-joint passive dynamics / limits, dof order as in the layout above
    damping = np.zeros(nd)
    stiffness = np.zeros(nd)
    springref = np.zeros(nd)
    limit_lo = np.full(nd, -inf)
    limit_hi = np.full(nd, inf)

    def joint(dof, lo, hi, damp=5.0, stiff=10.0, ref=0.0):
        limit_lo[dof], limit_hi[dof] = lo, hi
        damping[dof], stiffness[dof], springref[dof] = damp, stiff, ref

    # abdomen (gym ranges: z +-45deg, y -75..30deg, x +-35deg)
    joint(5 + ab1, -0.79, 0.79)
    joint(5 + ab2, -1.31, 0.52)
    joint(5 + pelvis, -0.61, 0.61)
    for h1, h2, thigh, shin in legs:
        joint(5 + h1, -0.45, 0.45)            # hip abduction
        joint(5 + h2, -0.60, 0.60)            # hip rotation
        joint(5 + thigh, -2.0, 0.6)           # hip flexion (negative = forward)
        joint(5 + shin, 0.0, 2.6, ref=0.05)   # knee flexion (positive = bend)
    for s1, upper, lower in arms:
        joint(5 + s1, -1.4, 1.4, damp=2.0, stiff=4.0)
        joint(5 + upper, -1.5, 1.5, damp=2.0, stiff=4.0)
        joint(5 + lower, -2.4, 0.0, damp=2.0, stiff=4.0)

    gear = np.zeros(nd)
    gear[5 + ab1] = gear[5 + ab2] = gear[5 + pelvis] = 90.0
    for h1, h2, thigh, shin in legs:
        gear[5 + h1] = 80.0
        gear[5 + h2] = 80.0
        gear[5 + thigh] = 180.0
        gear[5 + shin] = 140.0
    for s1, upper, lower in arms:
        gear[5 + s1] = gear[5 + upper] = gear[5 + lower] = 35.0
    actuator_dof = tuple(int(i) for i in range(6, nd))
    gear = gear[6:]

    cp = float(chart_center_pitch)
    root_rot_offset = np.array(
        [[np.cos(cp), 0.0, np.sin(cp)],
         [0.0, 1.0, 0.0],
         [-np.sin(cp), 0.0, np.cos(cp)]], np.float32)

    # small root angular damping (air drag): keeps the implicit solve
    # well-posed if a trajectory strays toward a singular chart direction
    damping[3:6] = 1.0

    return SpatialModel(
        parent=tuple(parent),
        anchor=np.asarray(anchor, np.float32),
        axis=np.asarray(axis, np.float32),
        com=np.asarray(com, np.float32),
        mass=np.asarray(mass, np.float32),
        inertia=np.asarray(inertia, np.float32),
        free_root=True,
        root_rot_offset=root_rot_offset,
        geom_body=tuple(geom_body),
        geom_pos=np.asarray(geom_pos, np.float32),
        geom_radius=np.asarray(geom_radius, np.float32),
        actuator_dof=actuator_dof,
        gear=gear.astype(np.float32),
        damping=damping.astype(np.float32),
        stiffness=stiffness.astype(np.float32),
        springref=springref.astype(np.float32),
        limit_lo=limit_lo.astype(np.float32),
        limit_hi=limit_hi.astype(np.float32),
        limit_stiffness=600.0,
        limit_damping=10.0,
        # kp bounded by the lightest contacting body (1.2 kg forearm)
        contact_kp=8.0e3,
        contact_kd=80.0,
        contact_fmax=900.0,
        friction_mu=1.0,
        friction_kt=280.0,
        # per-dof velocity caps: joints at ~1.5x the motor speed limit
        max_qd=np.concatenate([np.full(3, 15.0), np.full(3, 12.0),
                               np.full(_N_JOINTS, 12.0)]).astype(np.float32),
        motor_omega_max=8.0,     # power-limited joints
        energy_valve=True,
        dt=dt,
        n_substeps=n_substeps,
    )


class _Humanoid3DBase(SpatialEnv):
    nq = 6 + _N_JOINTS   # 23: [x, y, z, roll, pitch, yaw, 17 joints]
    nv = 6 + _N_JOINTS
    dt = 0.05
    _chart_center_pitch = 0.0   # root chart recentering (module docstring)

    def __init__(self, *, exclude_current_positions_from_observation: bool = False,
                 frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self._exclude_current_positions_from_observation = bool(
            exclude_current_positions_from_observation)
        n_substeps = 20 if frame_skip is None else 4 * int(frame_skip)
        self.model = make_humanoid3d_model(
            dt=self.dt, n_substeps=n_substeps,
            chart_center_pitch=self._chart_center_pitch)
        self.action_space = BoxSpace(low=[-1.0] * _N_JOINTS, high=[1.0] * _N_JOINTS)
        obs_dim = self.nq + self.nv
        if self._exclude_current_positions_from_observation:
            obs_dim -= 2
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim,
                                          high=[np.inf] * obs_dim)
        self.supports_state_from_obs = \
            not self._exclude_current_positions_from_observation

    # state = [q(23), qd(23)]; q[2] is the absolute torso height
    def observation(self, state):
        if self._exclude_current_positions_from_observation:
            return torch.cat([state[..., 2:self.nq], state[..., self.nq:]], dim=-1)
        return state

    def state_from_observation(self, observation):
        if observation.shape[-1] != self.nq + self.nv:
            raise AttributeError(
                "For GT model use, set "
                "'exclude_current_positions_from_observation': false")
        return observation

    def render_frame(self, state):
        """Sagittal (x, z) wireframe projection of the 3D skeleton."""
        return render_spatial_xz(self.model, state[..., : self.nq].cpu().numpy())


class HumanoidStandup3D(_Humanoid3DBase):
    """The gym HumanoidStandup task: starts supine, cost = -height +
    0.1*|a|^2 on the current observation."""

    name = "HumanoidStandup"
    _chart_center_pitch = -np.pi / 4
    _supine_chart_pitch = -np.pi / 4   # world -pi/2 minus the chart center

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        q = torch.zeros(self.nq, device=generator.device)
        q[2] = 0.16                                # torso center near ground
        q[4] = self._supine_chart_pitch            # supine (head toward -x)
        # knees slightly bent so heels can push (r_knee dof 12, l_knee 16)
        q[12] = 0.4
        q[16] = 0.4
        q = q + 0.01 * (torch.rand(self.nq, **kw) * 2.0 - 1.0)
        qd = 0.01 * torch.randn(self.nv, **kw)
        return torch.cat([q, qd])

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        height = new_state[..., 2]
        ctrl = 0.1 * torch.sum(torch.square(action), dim=-1)
        # gym standup reward analog: height gain rate minus quad ctrl cost
        reward = height / self.dt * 0.04 - ctrl + 1.0
        return obs, reward, torch.zeros_like(reward)

    def cost_fn(self, observation, action, next_obs):
        """-height + 0.1*|a|^2. Height sits at obs index 2 with positions
        included and at 0 with them excluded."""
        up_idx = 0 if self._exclude_current_positions_from_observation else 2
        up = observation[..., up_idx]
        ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=-1)
        return -up + ctrl_cost


class Humanoid3D(_Humanoid3DBase):
    """The gym Humanoid-v3 running task."""

    name = "Humanoid"
    _healthy_z_range = (1.0, 2.0)       # gym Humanoid-v3 default
    _ctrl_cost_weight = 0.1
    _forward_reward_weight = 1.25

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        q = torch.zeros(self.nq, device=generator.device)
        q[2] = _Z_STANCE + 0.02
        q = q + 0.01 * (torch.rand(self.nq, **kw) * 2.0 - 1.0)
        qd = 0.01 * torch.randn(self.nv, **kw)
        return torch.cat([q, qd])

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        x_vel = (new_state[..., 0] - state[..., 0]) / self.dt
        z = new_state[..., 2]
        healthy = ((z > self._healthy_z_range[0])
                   & (z < self._healthy_z_range[1])).to(torch.float32)
        reward = (self._forward_reward_weight * x_vel + 5.0 * healthy
                  - self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1))
        return obs, reward, 1.0 - healthy

    def unhealthy_states(self, states):
        """Both branches of the reference's unhealthy_states: z at index 0
        when positions are excluded, index 2 otherwise."""
        z = states[..., 0 if self._exclude_current_positions_from_observation else 2]
        min_z, max_z = self._healthy_z_range
        healthy = (z > min_z) & (z < max_z)
        finite = torch.all(torch.isfinite(states), dim=-1)
        return 1.0 - (healthy & finite).to(torch.float32)

    def cost_fn(self, observation, action, next_obs):
        """-w*x_vel + 100*unhealthy + ctrl cost; velocity at nq (or nq-2
        with positions excluded)."""
        unhealthy = self.unhealthy_states(observation)
        idx = (self.nq - 2 if self._exclude_current_positions_from_observation
               else self.nq)
        x_velocity = observation[..., idx]
        control_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        return (-self._forward_reward_weight * x_velocity
                + 100.0 * unhealthy + control_cost)
