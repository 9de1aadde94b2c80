"""dm_control-suite-flavored environments.

Counterpart of ``icem_tpu/envs/dm_suite.py``:

- CartPoleSuite: continuous-force swing-up cart-pole, analytic dynamics;
  obs [x, cos, sin, xd, thd]; the default masked-L2 cost on (cos, sin)
  against (1, 0)
- ReacherSuite / RestrictedReacherSuite: in icem_torch.envs.reacher
- DoubleIntSuite / RestrictedDoubleIntSuite: the point mass, goal at the
  origin, mode-dependent init
- HalfCheetahSuite: the cheetah with the position in the observation
  (18 dims) and the flip penalty
- SwimmerSuite: a 6-link swimmer with anisotropic fluid drag on the planar
  engine; obs = [joints (5), nose_to_target (2), body velocities (18)];
  cost = |nose_to_target| at obs[..., -20:-18]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, Env, uniform
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.envs.classic import PointMass
from icem_torch.envs.physics import batched
from icem_torch.envs.physics.planar import PlanarModel, chain_link_inertia
from icem_torch.envs.planar_base import PlanarEnv
from icem_torch.envs.reacher import ReacherSuite, RestrictedReacherSuite  # noqa: F401 (registry)


class CartPoleSuite(Env):
    """Continuous-force cart-pole swing-up.

    State [x, theta, xd, thd]; obs [x, cos, sin, xd, thd]; only the angle
    enters the cost (goal_state / goal_mask).
    """

    name = "cartpole"
    goal_state = np.array([0.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    goal_mask = np.array([0.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    # dm_control's cartpole physics step; with PlaNet's action repeat of 8 an
    # action is held for 0.08 s
    dt = 0.01
    gravity = 9.81
    masscart = 1.0
    masspole = 0.1
    pole_half_length = 0.5
    force_mag = 10.0
    x_limit = 1.8

    def __init__(self, *, task_name: str = "swingup", task_kwargs=None, **kwargs):
        kwargs.pop("visualize_reward", None)
        kwargs.pop("render_mode", None)
        super().__init__(**kwargs)
        self.task_name = task_name
        self.action_space = BoxSpace(low=[-1.0], high=[1.0])
        self.observation_space = BoxSpace(low=[-np.inf] * 5, high=[np.inf] * 5)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        if self.task_name == "swingup":
            theta = math.pi + uniform(generator, (), -0.1, 0.1)
        else:  # balance
            theta = uniform(generator, (), -0.1, 0.1)
        x = uniform(generator, (), -0.1, 0.1)
        return torch.stack([x, theta, 0.0 * x, 0.0 * x])

    def observation(self, state):
        x, theta, xd, thd = (state[..., 0], state[..., 1],
                             state[..., 2], state[..., 3])
        return torch.stack([x, torch.cos(theta), torch.sin(theta), xd, thd], dim=-1)

    def step(self, state, action):
        x, theta, xd, thd = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
        force = torch.clamp(action[..., 0], -1.0, 1.0) * self.force_mag

        total_mass = self.masscart + self.masspole
        pml = self.masspole * self.pole_half_length
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        temp = (force + pml * thd**2 * sin_t) / total_mass
        th_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_half_length * (4.0 / 3.0 - self.masspole * cos_t**2 / total_mass))
        x_acc = temp - pml * th_acc * cos_t / total_mass

        xd = xd + self.dt * x_acc
        x = torch.clamp(x + self.dt * xd, -self.x_limit, self.x_limit)
        thd = thd + self.dt * th_acc
        theta = theta + self.dt * thd
        new_state = torch.stack([x, theta, xd, thd], dim=-1)
        obs = self.observation(new_state)
        reward = -self.cost_fn(obs, action, obs)
        return new_state, obs, reward, torch.zeros_like(reward)

    def state_from_observation(self, observation):
        theta = torch.atan2(observation[..., 2], observation[..., 1])
        return torch.stack([observation[..., 0], theta,
                            observation[..., 3], observation[..., 4]], dim=-1)


class DoubleIntSuite(PointMass):
    """The dm-suite point_mass flavor."""

    name = "point_mass"

    def __init__(self, *, task_name: str = "easy", task_kwargs=None,
                 init_std=None, **kwargs):
        kwargs.pop("visualize_reward", None)
        kwargs.pop("render_mode", None)
        super().__init__(goal=(0.0, 0.0), **kwargs)
        self.task_name = task_name
        self.init_std = init_std


class RestrictedDoubleIntSuite(DoubleIntSuite):
    """Init near (0.2, 0.1) with mode-dependent noise."""

    name = "restricted_point_mass"

    def __init__(self, *, init_std=0.05, init_std_eval=None, **kwargs):
        super().__init__(**kwargs)
        self.init_std = float(init_std) if init_std is not None else None
        self.init_std_eval = float(init_std_eval) if init_std_eval is not None else None

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        std = self.init_std
        if mode == "evaluate" and self.init_std_eval is not None:
            std = self.init_std_eval
        if std is None:
            return super().init_state(generator, mode)
        noise = uniform(generator, (2,), -std, std)
        pos = torch.stack([0.2 + noise[0], 0.1 + noise[1]])
        return torch.cat([pos, torch.zeros_like(pos)])


class HalfCheetahSuite(HalfCheetah):
    """The cheetah with the position in the observation (18 dims), the same
    velocity cost, the flip penalty on by default."""

    name = "cheetah"

    def __init__(self, *, task_name: str = "run", task_kwargs=None,
                 penalise_flipping: bool = True, **kwargs):
        kwargs.pop("visualize_reward", None)
        kwargs.pop("render_mode", None)
        kwargs.pop("exclude_current_positions_from_observation", None)
        super().__init__(exclude_current_positions_from_observation=False,
                         penalise_flipping=penalise_flipping, **kwargs)
        self.task_name = task_name


def make_swimmer_model(n_links: int = 6, link_len: float = 0.1,
                       dt: float = 0.03, n_substeps: int = 6) -> PlanarModel:
    inf = np.inf
    masses = np.full(n_links, 0.1, np.float32)
    inertia = np.full(n_links, chain_link_inertia(0.1, link_len), np.float32)
    # chain along +x; root is the head link
    anchor = np.zeros((n_links, 2), np.float32)
    anchor[1:, 0] = -link_len  # each child attaches at the parent's tail
    com = np.tile(np.array([-link_len / 2, 0.0], np.float32), (n_links, 1))
    n_dof = 3 + n_links - 1
    return PlanarModel(
        parent=tuple([-1] + list(range(n_links - 1))),
        anchor=anchor,
        com=com,
        mass=masses,
        inertia=inertia,
        free_root=True,
        actuator_dof=tuple(range(3, n_dof)),
        gear=np.full(n_links - 1, 0.25, np.float32),
        damping=np.concatenate([np.zeros(3), np.full(n_links - 1, 0.02)]).astype(np.float32),
        stiffness=np.zeros(n_dof, np.float32),
        springref=np.zeros(n_dof, np.float32),
        limit_lo=np.concatenate([np.full(3, -inf), np.full(n_links - 1, -1.75)]).astype(np.float32),
        limit_hi=np.concatenate([np.full(3, inf), np.full(n_links - 1, 1.75)]).astype(np.float32),
        drag_normal=np.full(n_links, 12.0, np.float32),
        drag_tangent=np.full(n_links, 0.4, np.float32),
        drag_angular=np.full(n_links, 0.05, np.float32),
        gravity=0.0,  # top-down plane
        dt=dt,
        n_substeps=n_substeps,
    )


class SwimmerSuite(PlanarEnv):
    """6-link swimmer chasing a target.

    State = [q (8 = 3 root + 5 joints), qd (8), target_xy (2)].
    Obs (25) = [joint angles (5), nose_to_target (2), per-link
    (vx, vz, omega) body velocities (18)]; cost = |obs[..., 5:7]|
    (== obs[..., -20:-18], the reference's index arithmetic).
    """

    name = "swimmer"
    n_links = 6
    link_len = 0.1
    dt = 0.03

    def __init__(self, *, task_name: str = "swimmer6", task_kwargs=None, **kwargs):
        kwargs.pop("visualize_reward", None)
        kwargs.pop("render_mode", None)
        super().__init__(**kwargs)
        self.task_name = task_name
        self.model = make_swimmer_model(self.n_links, self.link_len, self.dt)
        n_act = self.n_links - 1
        self.action_space = BoxSpace(low=[-1.0] * n_act, high=[1.0] * n_act)
        self.observation_space = BoxSpace(low=[-np.inf] * 25, high=[np.inf] * 25)
        self.supports_state_from_obs = False

    @property
    def _ndof(self):
        return 3 + self.n_links - 1

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        heading = uniform(generator, (), -math.pi, math.pi)
        angle = uniform(generator, (), 0.0, 2 * math.pi)
        q = torch.zeros(self._ndof, device=heading.device)
        q[2] = heading
        target = 0.4 * torch.stack([torch.cos(angle), torch.sin(angle)])
        return torch.cat([q, torch.zeros_like(q), target])

    def _body_velocities(self, q, qd):
        """Per body: the COM's velocity (vx, vz) and the angular velocity,
        what a forward-mode derivative of the forward kinematics along qd
        gives, over leading batch dimensions. q, qd: lists of ndof rows."""
        model = self.model
        ox, oz, cs, sn = batched._fk_core(model, q)
        hinges = batched._hinge_ancestors(model, batched._ancestors(model))
        com = np.asarray(model.com, np.float64).tolist()
        out = []
        for b in range(model.nbody):
            cx = ox[b] + cs[b] * com[b][0] - sn[b] * com[b][1]
            cz = oz[b] + sn[b] * com[b][0] + cs[b] * com[b][1]
            vx, vz, w = qd[0], qd[1], 0.0
            for j, c in hinges[b]:
                vx = vx - qd[j] * (cz - oz[c])
                vz = vz + qd[j] * (cx - ox[c])
                w = w + qd[j]
            out += [vx, vz, w]
        return torch.stack(out, dim=-1)

    def observation(self, state):
        nd = self._ndof
        q = [state[..., j] for j in range(nd)]
        qd = [state[..., nd + j] for j in range(nd)]
        nose = state[..., 0:2]
        target = state[..., 2 * nd:]
        return torch.cat([state[..., 3:nd], target - nose, self._body_velocities(q, qd)],
                         dim=-1)

    def _post_step(self, state, new_state, action):
        obs = self.observation(new_state)
        reward = -torch.linalg.vector_norm(obs[..., 5:7], dim=-1)
        return obs, reward, torch.zeros_like(reward)

    def cost_fn(self, states, actions, next_states):
        return torch.linalg.vector_norm(states[..., -20:-18], dim=-1)
