"""Fetch goal-conditioned manipulation (Reach, Pick&Place): analytic, no kernel.

Counterpart of ``icem_tpu/envs/fetch.py``: a workspace-clamped end-effector
integrator with symmetric gripper fingers, and for Pick&Place a grasp-carry
object model with table support, gravity and pushing contact. Observations
are [observation core, desired goal] (Reach 10 + 3, Pick&Place 25 + 3); the
achieved goal is the gripper (Reach) or the object (Pick&Place). The state
carries the goal, so planners restore a scene exactly.

Every ``step`` works over leading batch dimensions, so the population step
is the same function (``Env.step_batched``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, MaskedGoalSpaceEnv, uniform

# workspace geometry (gym fetch ballpark)
GRIPPER_INIT = np.array([1.34, 0.75, 0.53], np.float32)
TABLE_HEIGHT = 0.425
OBJ_HALF_HEIGHT = 0.025
WS_LOW = np.array([1.05, 0.40, TABLE_HEIGHT + 0.0], np.float32)
WS_HIGH = np.array([1.60, 1.10, 0.95], np.float32)
POS_SCALE = 0.05      # action -> EE displacement per step
GRIP_SCALE = 0.015
OBJ_RANGE = 0.15
TARGET_RANGE = 0.15
# free-object velocity damping per step (table friction)
_FRICTION = np.array([0.8, 0.8, 1.0], np.float32)


def _with_z(xyz, z):
    """``xyz`` [..., 3] with its last entry replaced by ``z`` [...]."""
    return torch.cat([xyz[..., :2], z[..., None]], dim=-1)


class _FetchBase(MaskedGoalSpaceEnv):
    dt = 0.04
    has_object = False
    obs_core_dim = 10

    def __init__(self, *, sparse: bool, threshold: float = 0.05, fixed_goal=None, **kwargs):
        core = self.obs_core_dim
        goal_idx = np.arange(core, core + 3)
        achieved = [3, 4, 5] if self.has_object else [0, 1, 2]
        super().__init__(goal_idx=goal_idx, achieved_goal_idx=achieved,
                         sparse=sparse, threshold=threshold, **kwargs)
        self.fixed_goal = None if fixed_goal is None else np.asarray(fixed_goal, np.float32)
        self.action_space = BoxSpace(low=[-1.0] * 4, high=[1.0] * 4)
        self.observation_space = BoxSpace(low=[-np.inf] * (core + 3), high=[np.inf] * (core + 3))
        self.supports_state_from_obs = False

    def state_from_observation(self, observation):
        raise NotImplementedError(f"{self.name} env needs the real GT states to be reset")

    def _move_gripper(self, ee, grip, action):
        """(new end effector, its velocity, new finger opening)."""
        low, high = self._constants(ee.device, WS_LOW, WS_HIGH)
        new_ee = torch.clamp(ee + action[..., :3] * POS_SCALE, low, high)
        vel = (new_ee - ee) / self.dt
        new_grip = torch.clamp(grip + action[..., 3] * GRIP_SCALE, 0.0, 0.05)
        return new_ee, vel, new_grip

    def _sample_goal(self, generator: torch.Generator):
        """The episode's goal, on the generator's device."""
        (init,) = self._constants(generator.device, GRIPPER_INIT)
        table = torch.full((), TABLE_HEIGHT + OBJ_HALF_HEIGHT, device=generator.device)
        if self.fixed_goal is not None:
            (fixed,) = self._constants(generator.device, self.fixed_goal)
            if self.has_object:
                goal = _with_z(init + fixed * TARGET_RANGE, table)
                return _with_z(goal, goal[2] + float(self.fixed_goal[2]) * 0.45)
            return init + fixed
        if self.has_object:
            goal = _with_z(init + uniform(generator, (3,), -TARGET_RANGE, TARGET_RANGE), table)
            in_air = uniform(generator, (), 0.0, 1.0) < 0.5
            lift = uniform(generator, (), 0.0, 0.45)
            return _with_z(goal, goal[2] + torch.where(in_air, lift, 0.0))
        return init + uniform(generator, (3,), -0.15, 0.15)


class FetchReach(_FetchBase):
    """State = [ee (3), grip (1), ee_vel (3), goal (3)].
    Obs (13) = [grip_pos (3), finger state (2), grip velp (3), finger vel (2),
    goal (3)]."""

    name = "FetchReach"
    obs_core_dim = 10
    has_object = False

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        goal = self._sample_goal(generator)
        (ee,) = self._constants(generator.device, GRIPPER_INIT)
        return torch.cat([ee, torch.zeros(4, device=generator.device), goal])

    def observation(self, state):
        ee, grip, vel, goal = state[..., :3], state[..., 3:4], state[..., 4:7], state[..., 7:10]
        half = grip / 2.0
        zero = torch.zeros_like(half)
        return torch.cat([ee, half, half, vel * self.dt, zero, zero, goal], dim=-1)

    def step(self, state, action):
        ee, grip, goal = state[..., :3], state[..., 3], state[..., 7:10]
        action = torch.clamp(action, -1.0, 1.0)
        new_ee, vel, new_grip = self._move_gripper(ee, grip, action)
        new_state = torch.cat([new_ee, new_grip[..., None], vel, goal], dim=-1)
        obs = self.observation(new_state)
        reward = self.reward_fn(obs, action, obs)
        return new_state, obs, reward, torch.zeros_like(reward)


class FetchPickAndPlace(_FetchBase):
    """State = [ee (3), grip (1), obj_pos (3), obj_vel (3), attached (1),
    goal (3)].
    Obs (28) = [grip_pos (3), obj_pos (3), obj_rel (3), fingers (2),
    obj_rot (3) = 0, obj_velp (3), obj_velr (3) = 0, grip_velp (3) = 0,
    finger_vel (2) = 0, goal (3)]: the zero slots keep the 25-dim core
    layout of the gym env, so the goal indices line up."""

    name = "FetchPickAndPlace"
    obs_core_dim = 25
    has_object = True
    GRASP_DIST = 0.04      # EE-object distance below which closing grasps
    GRIP_CLOSED = 0.03     # finger opening below which the object is held
    CONTACT_DIST = 0.05    # EE-object overlap radius for pushing contact

    def __init__(self, *, sparse: bool, threshold: float = 0.05, fixed_object_pos=None,
                 fixed_goal=None, shaped_reward: bool = False, **kwargs):
        super().__init__(sparse=sparse, threshold=threshold, fixed_goal=fixed_goal, **kwargs)
        self.fixed_object_pos = None if fixed_object_pos is None \
            else np.asarray(fixed_object_pos, np.float32)
        self.shaped_reward = bool(shaped_reward)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        device = generator.device
        goal = self._sample_goal(generator)
        (init,) = self._constants(device, GRIPPER_INIT)
        if self.fixed_object_pos is not None:
            (fixed,) = self._constants(device, self.fixed_object_pos)
            obj_xy = init[:2] + fixed[:2] * OBJ_RANGE
        else:
            # the object on a ring of radius [0.1, OBJ_RANGE] around the
            # gripper: at least 0.1 away, without rejection sampling
            ang = uniform(generator, (), 0.0, 2 * math.pi)
            rad = uniform(generator, (), 0.1, OBJ_RANGE)
            obj_xy = init[:2] + rad * torch.stack([torch.cos(ang), torch.sin(ang)])
        obj = torch.cat([obj_xy, torch.full((1,), TABLE_HEIGHT + OBJ_HALF_HEIGHT, device=device)])
        return torch.cat([init, torch.full((1,), 0.05, device=device), obj,
                          torch.zeros(4, device=device), goal])

    def observation(self, state):
        ee, grip = state[..., :3], state[..., 3:4]
        obj, obj_vel = state[..., 4:7], state[..., 7:10]
        goal = state[..., 11:14]
        half = grip / 2.0
        zeros3, zero = torch.zeros_like(obj), torch.zeros_like(half)
        return torch.cat([ee, obj, obj - ee, half, half, zeros3, obj_vel * self.dt, zeros3,
                          zeros3, zero, zero, goal], dim=-1)

    def step(self, state, action):
        ee, grip = state[..., :3], state[..., 3]
        obj, obj_vel = state[..., 4:7], state[..., 7:10]
        attached, goal = state[..., 10], state[..., 11:14]
        action = torch.clamp(action, -1.0, 1.0)
        new_ee, ee_vel, new_grip = self._move_gripper(ee, grip, action)

        near = torch.linalg.vector_norm(obj - ee, dim=-1) < self.GRASP_DIST
        closing = new_grip < self.GRIP_CLOSED
        new_attached = torch.where(near & closing, 1.0, torch.where(closing, attached, 0.0))

        # attached: the object rides the gripper; free: gravity and table
        (friction,) = self._constants(state.device, _FRICTION)
        free_vel = _with_z(obj_vel, obj_vel[..., 2] + -9.81 * self.dt) * friction
        free_pos = obj + free_vel * self.dt

        # pushing contact: the gripper displaces a free object it sweeps
        # through, which gives the dense unshaped cost a gradient to follow
        delta = free_pos - new_ee
        dist = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
        dirn = delta / torch.clamp(dist, min=1e-8)
        pen = torch.clamp(self.CONTACT_DIST - dist, min=0.0)
        free_pos = free_pos + dirn * pen
        free_vel = free_vel + dirn * pen / self.dt

        floor = TABLE_HEIGHT + OBJ_HALF_HEIGHT
        on_table = free_pos[..., 2] <= floor
        free_pos = _with_z(free_pos, torch.clamp(free_pos[..., 2], min=floor))
        free_vel = _with_z(free_vel, torch.where(on_table, 0.0, free_vel[..., 2]))

        held = new_attached[..., None] > 0
        new_obj = torch.where(held, new_ee, free_pos)
        new_obj_vel = torch.where(held, ee_vel, free_vel)

        new_state = torch.cat([new_ee, new_grip[..., None], new_obj, new_obj_vel,
                               new_attached[..., None], goal], dim=-1)
        obs = self.observation(new_state)
        reward = self.reward_fn(obs, action, obs)
        return new_state, obs, reward, torch.zeros_like(reward)

    def cost_fn(self, observation, action, next_obs):
        """Sparse or dense, with the optional shaped end-effector term."""
        dist_box_to_goal = self._goal_distance(observation)
        if self.shaped_reward:
            dist_ee_to_box = torch.linalg.vector_norm(
                observation[..., :3] - observation[..., 3:6], dim=-1)
        if self.sparse:
            cost = (dist_box_to_goal > self.threshold).to(torch.float32)
            if self.shaped_reward:
                cost = cost + 0.1 * (dist_ee_to_box > self.threshold).to(torch.float32)
            return cost
        if self.shaped_reward:
            return dist_box_to_goal + 0.1 * dist_ee_to_box
        return dist_box_to_goal
