"""HalfCheetah: planar running quadruped on the planar engine.

Counterpart of ``icem_tpu/envs/cheetah.py``:

- 9 dofs ([rootx, rootz, rooty, bthigh, bshin, bfoot, fthigh, fshin, ffoot]),
  6 torque actuators
- observation = [qpos (optionally excluding rootx), qvel] -> 17 or 18 dims
- step reward = forward_weight * x_velocity - 0.1 * |a|^2 from the position
  delta over the control step
- batched cost_fn with the 17/18-dim index handling and the optional flip
  penalty
- ground-truth state = [qpos, qvel]; state_from_observation requires the
  18-dim observation
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.planar_base import PlanarEnv


def make_cheetah_model(dt: float = 0.05, n_substeps: int = 10) -> PlanarModel:
    # body frame tip offsets (define the stance at q = 0)
    tips = {
        "bthigh": (0.07, -0.28),
        "bshin": (-0.06, -0.25),
        "bfoot": (0.18, -0.03),
        "fthigh": (-0.07, -0.26),
        "fshin": (0.05, -0.23),
        "ffoot": (0.12, -0.02),
    }
    z0 = 0.60  # standing root height

    def length(t):
        return math.hypot(*t)

    masses = np.array([6.25, 1.54, 1.59, 1.07, 1.44, 1.17, 0.85], np.float32)
    lengths = np.array([1.0] + [length(tips[k]) for k in
                                ("bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot")],
                       np.float32)
    inertia = masses * lengths**2 / 12.0

    anchor = np.array([
        [0.0, z0],            # torso root offset
        [-0.5, 0.0],          # bthigh at back of torso
        tips["bthigh"],       # bshin at bthigh tip
        tips["bshin"],        # bfoot at bshin tip
        [0.5, 0.0],           # fthigh at front of torso
        tips["fthigh"],       # fshin
        tips["fshin"],        # ffoot
    ], np.float32)
    com = np.array([[0.0, 0.0]] + [[tips[k][0] / 2, tips[k][1] / 2] for k in
                                   ("bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot")],
                   np.float32)

    # contact spheres: feet tips, knees, torso ends
    geom_body = (3, 6, 2, 5, 0, 0)
    geom_pos = np.array([
        tips["bfoot"], tips["ffoot"], tips["bshin"], tips["fshin"],
        [-0.5, 0.0], [0.5, 0.1],
    ], np.float32)
    geom_radius = np.array([0.046] * 6, np.float32)

    inf = np.inf
    return PlanarModel(
        parent=(-1, 0, 1, 2, 0, 4, 5),
        anchor=anchor,
        com=com,
        mass=masses,
        inertia=inertia.astype(np.float32),
        free_root=True,
        geom_body=geom_body,
        geom_pos=geom_pos,
        geom_radius=geom_radius,
        actuator_dof=(3, 4, 5, 6, 7, 8),
        gear=np.array([120, 90, 60, 120, 60, 30], np.float32),
        damping=np.array([0, 0, 0, 6, 4.5, 3, 4.5, 3, 1.5], np.float32),
        stiffness=np.array([0, 0, 0, 240, 180, 120, 180, 120, 60], np.float32),
        springref=np.zeros(9, np.float32),
        limit_lo=np.array([-inf, -inf, -inf, -0.52, -0.785, -0.4, -1.0, -1.2, -0.5],
                          np.float32),
        limit_hi=np.array([inf, inf, inf, 1.05, 0.785, 0.785, 0.7, 0.87, 0.5],
                          np.float32),
        limit_stiffness=500.0,
        limit_damping=8.0,
        contact_kp=1.0e4,
        contact_kd=50.0,
        contact_fmax=1200.0,   # ~9x body weight
        friction_mu=0.8,
        friction_kt=200.0,
        max_qd=50.0,
        dt=dt,
        n_substeps=n_substeps,
    )


class HalfCheetah(PlanarEnv):
    """The gym half_cheetah task on the planar engine."""

    name = "HalfCheetah"
    nq = 9
    nv = 9
    dt = 0.05

    def __init__(self, *, exclude_current_positions_from_observation: bool = True,
                 penalise_flipping: bool = False, frame_skip=None,
                 forward_reward_weight: float = 1.0, ctrl_cost_weight: float = 0.1,
                 **kwargs):
        super().__init__(**kwargs)
        self.exclude_current_positions = bool(exclude_current_positions_from_observation)
        self.penalise_flipping = bool(penalise_flipping)
        self._forward_reward_weight = float(forward_reward_weight)
        self._ctrl_cost_weight = float(ctrl_cost_weight)
        n_substeps = 20 if frame_skip is None else 4 * int(frame_skip)
        self.model = make_cheetah_model(dt=self.dt, n_substeps=n_substeps)
        self.action_space = BoxSpace(low=[-1.0] * 6, high=[1.0] * 6)
        obs_dim = (self.nq - 1 if self.exclude_current_positions else self.nq) + self.nv
        self.observation_space = BoxSpace(low=[-np.inf] * obs_dim, high=[np.inf] * obs_dim)
        self.supports_state_from_obs = not self.exclude_current_positions

    # -- state <-> observation --------------------------------------------
    def init_state(self, generator: torch.Generator, mode: str = "train"):
        kw = dict(generator=generator, device=generator.device)
        qpos = torch.rand(self.nq, **kw) * 0.2 - 0.1
        qvel = 0.1 * torch.randn(self.nv, **kw)
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

    # -- dynamics (physics via PlanarEnv.step_batched / rollout_batched) ---
    def _post_step(self, state, new_state, action):
        x_velocity = (new_state[..., 0] - state[..., 0]) / self.dt
        ctrl_cost = self._ctrl_cost_weight * torch.sum(torch.square(action), dim=-1)
        reward = self._forward_reward_weight * x_velocity - ctrl_cost
        return self.observation(new_state), reward, torch.zeros_like(reward)

    # -- cost: the reference's semantics ------------------------------------
    def cost_fn(self, states, actions, next_states=None):
        d = states.shape[-1]
        if d == 18:
            root_angle = states[..., 2]
            velocity = states[..., 9]
        elif d == 17:
            root_angle = states[..., 1]
            velocity = states[..., 8]
        else:
            raise ValueError(
                f"Got state of dimension {d}. Possible dimensions are 17 or 18.")

        scores = torch.zeros(actions.shape[:-1], dtype=actions.dtype, device=actions.device)
        if self.penalise_flipping:
            heading_penalty_factor = 10.0
            scores = scores + (root_angle > math.pi / 2) * heading_penalty_factor
            scores = scores + (root_angle < -math.pi / 2) * heading_penalty_factor
        scores = scores + 0.1 * torch.sum(actions**2, dim=-1)
        scores = scores - velocity
        return scores
