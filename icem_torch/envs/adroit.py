"""Adroit-hand manipulation: Door and Relocate, analytic, no kernel.

Counterpart of ``icem_tpu/envs/adroit.py``: the palm is a workspace-clamped
point driven by the arm actuators, the finger joints are first-order servos
whose mean closure is the grasp signal, and the door latch and hinge and the
relocate ball have explicit dynamics coupled to palm contact and grasp. The
observation layouts, the costs with their bonus tiers and the success
predicates are the JAX package's; the state carries the randomized scene
(door frame, object and target), so planners restore a scene exactly.

Every ``step`` works over leading batch dimensions, so the population step
is the same function (``Env.step_batched``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icem_torch.envs.base import BoxSpace, Env, uniform

PALM_SPEED = 0.5       # m/s from arm actuators
FINGER_RATE = 8.0      # first-order servo rate for finger joints

_DOOR_PALM_LOW = np.array([-0.6, -0.6, 0.0], np.float32)
_DOOR_PALM_HIGH = np.array([0.6, 0.6, 0.6], np.float32)
_DOOR_PALM0 = np.array([-0.1, 0.2, 0.25], np.float32)
_DOOR_FRAME = np.array([0.0, -0.25], np.float32)
_DOOR_FRAME_LOW = np.array([-0.3, -0.05], np.float32)
_DOOR_FRAME_HIGH = np.array([0.0, 0.05], np.float32)
_RELOCATE_PALM_LOW = np.array([-0.5, -0.5, 0.025], np.float32)
_RELOCATE_PALM_HIGH = np.array([0.5, 0.5, 0.6], np.float32)
_RELOCATE_PALM0 = np.array([0.0, -0.2, 0.25], np.float32)
_RELOCATE_OBJ_LOW = np.array([-0.15, -0.15], np.float32)
_RELOCATE_OBJ_HIGH = np.array([0.15, 0.3], np.float32)
_RELOCATE_FRICTION = np.array([0.7, 0.7, 1.0], np.float32)


def _servo(hand_q, a, dt: float):
    """Finger servos tracking their commands, and the grasp signal (their
    mean closure in [0, 1])."""
    fingers = hand_q[..., 3:] + FINGER_RATE * dt * (a[..., 3:] - hand_q[..., 3:])
    return fingers, torch.clamp(torch.mean(fingers, dim=-1), 0.0, 1.0)


class Door(Env):
    """State (35) = [hand_q (28), door_angle, latch_angle, palm (3),
    frame_xy (2)]. hand_q[0:3] hold the arm commands (the palm is the
    integrated position); hand_q[3:] are the finger servos.
    Obs (39) = [hand_q[1:] (27), latch, door_pos, palm (3), handle (3),
    palm - handle (3), door_open]."""

    name = "Door"
    n_hand = 28
    dt = 0.05
    HANDLE_RADIUS = 0.35   # handle lever arm from the hinge
    HANDLE_HEIGHT = 0.25
    REACH_DIST = 0.07      # palm must be placed AT the handle, not near it
    GRASP_MIN = 0.1        # mean finger closure below which nothing grips
    LATCH_GAIN = 6.0       # latch servo target per unit effective grasp

    def __init__(self, *, shaped_reward: bool = True, add_bonus_rewards: bool = True,
                 use_normalized_actions: bool = False, frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.shaped_reward = bool(shaped_reward)
        self.add_bonus_rewards = bool(add_bonus_rewards)
        self.action_space = BoxSpace(low=[-1.0] * self.n_hand, high=[1.0] * self.n_hand)
        self.observation_space = BoxSpace(low=[-np.inf] * 39, high=[np.inf] * 39)
        self.supports_state_from_obs = False
        self.door_pos_idx = np.array([28])
        self.palm_pos_idx = np.arange(29, 32)
        self.handle_pos_idx = np.arange(32, 35)
        self.qv_start_idx = 30

    def _handle_pos(self, door_angle, frame_xy):
        """The handle at the door's far edge; the door swings about the
        vertical hinge at ``frame_xy``. Broadcasts over leading dimensions."""
        angle = door_angle + math.pi / 2
        xy = frame_xy + self.HANDLE_RADIUS * torch.stack([torch.cos(angle), torch.sin(angle)],
                                                         dim=-1)
        return torch.cat([xy, torch.full_like(xy[..., :1], self.HANDLE_HEIGHT)], dim=-1)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        device = generator.device
        frame, low, high = self._constants(device, _DOOR_FRAME, _DOOR_FRAME_LOW, _DOOR_FRAME_HIGH)
        frame_xy = frame + (low + torch.rand(2, generator=generator, device=device) * (high - low))
        (palm,) = self._constants(device, _DOOR_PALM0)
        return torch.cat([torch.zeros(self.n_hand + 2, device=device), palm, frame_xy])

    def _unpack(self, state):
        return (state[..., :28], state[..., 28], state[..., 29], state[..., 30:33],
                state[..., 33:35])

    def observation(self, state):
        hand_q, door, latch, palm, frame_xy = self._unpack(state)
        handle = self._handle_pos(door, frame_xy)
        door_open = torch.where(door > 1.0, 1.0, -1.0)
        return torch.cat([hand_q[..., 1:], latch[..., None], door[..., None], palm, handle,
                          palm - handle, door_open[..., None]], dim=-1)

    def step(self, state, action):
        hand_q, door, latch, palm, frame_xy = self._unpack(state)
        a = torch.clamp(action, -1.0, 1.0)
        low, high = self._constants(state.device, _DOOR_PALM_LOW, _DOOR_PALM_HIGH)
        new_palm = torch.clamp(palm + a[..., :3] * PALM_SPEED * self.dt, low, high)
        fingers, grasp = _servo(hand_q, a, self.dt)
        new_hand = torch.cat([a[..., :3], fingers], dim=-1)

        handle = self._handle_pos(door, frame_xy)
        near = torch.linalg.vector_norm(new_palm - handle, dim=-1) < self.REACH_DIST

        # the latch turns only under a coordinated grasp at the handle (the
        # dead zone lies several sigma outside the finger mean's exploration
        # noise) and springs back otherwise
        eff_grasp = torch.clamp((grasp - self.GRASP_MIN) / (1.0 - self.GRASP_MIN), 0.0, 1.0)
        latch_target = torch.where(near, self.LATCH_GAIN * eff_grasp, 0.0)
        new_latch = torch.clamp(latch + 6.0 * self.dt * (latch_target - latch), 0.0, 1.8)
        unlatched = new_latch > 1.0

        # the door follows the palm's pull along the handle's arc when grasped
        # and unlatched; released, it swings shut on its spring
        angle = door + math.pi / 2
        tangent = torch.stack([-torch.sin(angle), torch.cos(angle)], dim=-1)
        pull = torch.sum((new_palm - palm)[..., :2] * tangent, dim=-1) / self.HANDLE_RADIUS
        pulling = near & unlatched & (grasp > self.GRASP_MIN)
        door_delta = torch.where(pulling, pull, 0.0)
        released = 1.0 - pulling.to(door.dtype)
        new_door = torch.clamp(door + door_delta - 1.0 * self.dt * door * released, 0.0, 1.6)
        # the palm sticks to the handle's arc while pulling
        new_palm = torch.where(pulling[..., None], self._handle_pos(new_door, frame_xy), new_palm)

        new_state = torch.cat([new_hand, new_door[..., None], new_latch[..., None], new_palm,
                               frame_xy], dim=-1)
        obs = self.observation(new_state)
        reward = -self.cost_fn(obs, action, obs)
        return new_state, obs, reward, torch.zeros_like(reward)

    def is_success(self, observation, action, next_obs):
        return (next_obs[..., self.door_pos_idx[0]] >= 1.35).to(torch.float32)

    def cost_fn(self, observations, actions, next_observations):
        handle_pos = observations[..., 32:35]
        palm_pos = observations[..., 29:32]
        door_pos = observations[..., 28]

        if self.shaped_reward:
            cost = 0.1 * torch.linalg.vector_norm(palm_pos - handle_pos, dim=-1)
        else:
            cost = torch.zeros_like(door_pos)
        cost = cost + 0.1 * (door_pos - 1.57) * (door_pos - 1.57)
        cost = cost + 1e-5 * torch.sum(observations[..., -self.qv_start_idx:] ** 2, dim=-1)
        if self.add_bonus_rewards:
            cost = cost - 2.0 * (door_pos > 0.2).to(cost.dtype)
            cost = cost - 8.0 * (door_pos > 1.0).to(cost.dtype)
            cost = cost - 10.0 * (door_pos > 1.35).to(cost.dtype)
        return cost

    def state_from_observation(self, observation):
        raise NotImplementedError("Door planning requires GT env states")


class Relocate(Env):
    """State (40) = [hand_q (30), obj (3), obj_vel (3), attached (1),
    target (3)]; the palm is hand_q[0:3].
    Obs (42) = [hand_q (30), palm - obj (3), palm - target (3),
    obj - target (3), obj (3)]."""

    name = "Relocate"
    n_hand = 30
    dt = 0.05
    GRASP_DIST = 0.04      # palm must reach INTO the ball to grasp it
    GRASP_MIN = 0.3        # coordinated-closure dead zone (see Door.step)
    TABLE_Z = 0.035        # ball resting height

    def __init__(self, *, add_bonus_rewards: bool = True, use_normalized_actions: bool = False,
                 frame_skip=None, **kwargs):
        super().__init__(**kwargs)
        self.add_bonus_rewards = bool(add_bonus_rewards)
        self.action_space = BoxSpace(low=[-1.0] * self.n_hand, high=[1.0] * self.n_hand)
        self.observation_space = BoxSpace(low=[-np.inf] * 42, high=[np.inf] * 42)
        self.supports_state_from_obs = False
        self.palm_pos_minus_obj_pos_idx = np.arange(30, 33)
        self.palm_pos_minus_target_pos_idx = np.arange(33, 36)
        self.obj_pos_minus_target_pos_idx = np.arange(36, 39)

    def init_state(self, generator: torch.Generator, mode: str = "train"):
        device = generator.device
        low, high = self._constants(device, _RELOCATE_OBJ_LOW, _RELOCATE_OBJ_HIGH)
        obj_xy = low + torch.rand(2, generator=generator, device=device) * (high - low)
        target = torch.cat([uniform(generator, (2,), -0.2, 0.2),
                            uniform(generator, (1,), 0.15, 0.35)])
        obj = torch.cat([obj_xy, torch.full((1,), self.TABLE_Z, device=device)])
        # the palm starts above the workspace center
        (palm,) = self._constants(device, _RELOCATE_PALM0)
        return torch.cat([palm, torch.zeros(self.n_hand - 3, device=device), obj,
                          torch.zeros(4, device=device), target])

    def _unpack(self, state):
        return (state[..., :30], state[..., 30:33], state[..., 33:36], state[..., 36],
                state[..., 37:40])

    def observation(self, state):
        hand_q, obj, _, _, target = self._unpack(state)
        palm = hand_q[..., 0:3]
        return torch.cat([hand_q, palm - obj, palm - target, obj - target, obj], dim=-1)

    def step(self, state, action):
        hand_q, obj, obj_vel, attached, target = self._unpack(state)
        a = torch.clamp(action, -1.0, 1.0)
        palm = hand_q[..., 0:3]
        low, high = self._constants(state.device, _RELOCATE_PALM_LOW, _RELOCATE_PALM_HIGH)
        new_palm = torch.clamp(palm + a[..., :3] * PALM_SPEED * self.dt, low, high)
        fingers, grasp = _servo(hand_q, a, self.dt)
        new_hand = torch.cat([new_palm, fingers], dim=-1)

        # picking up takes a coordinated closure at the ball, and carrying
        # takes keeping the hand closed (a hysteresis floor)
        near = torch.linalg.vector_norm(obj - new_palm, dim=-1) < self.GRASP_DIST
        closing = grasp > self.GRASP_MIN
        holding = grasp > 0.2
        new_attached = torch.where(near & closing, 1.0, torch.where(holding, attached, 0.0))

        palm_vel = (new_palm - palm) / self.dt
        (friction,) = self._constants(state.device, _RELOCATE_FRICTION)
        fall = torch.cat([obj_vel[..., :2], obj_vel[..., 2:] + -9.81 * self.dt], dim=-1)
        free_vel = fall * friction
        free_obj = obj + free_vel * self.dt
        on_table = free_obj[..., 2:] <= self.TABLE_Z
        free_obj = torch.cat([free_obj[..., :2], torch.clamp(free_obj[..., 2:], min=self.TABLE_Z)],
                             dim=-1)
        free_vel = torch.cat([free_vel[..., :2], torch.where(on_table, 0.0, free_vel[..., 2:])],
                             dim=-1)

        held = new_attached[..., None] > 0
        new_obj = torch.where(held, new_palm, free_obj)
        new_obj_vel = torch.where(held, palm_vel, free_vel)

        new_state = torch.cat([new_hand, new_obj, new_obj_vel, new_attached[..., None], target],
                              dim=-1)
        obs = self.observation(new_state)
        reward = -self.cost_fn(obs, action, obs)
        return new_state, obs, reward, torch.zeros_like(reward)

    def is_success(self, observation, action, next_obs):
        d = torch.linalg.vector_norm(next_obs[..., 36:39], dim=-1)
        return (d < 0.1).to(torch.float32)

    def cost_fn(self, observations, actions, next_observations):
        obj_pos = observations[..., -3:]
        palm_minus_obj = observations[..., 30:33]
        obj_minus_target = observations[..., 36:39]

        cost = 0.1 * torch.linalg.vector_norm(palm_minus_obj, dim=-1)
        lifted = (obj_pos[..., 2] > 0.04).to(cost.dtype)
        d = torch.linalg.vector_norm(obj_minus_target, dim=-1)
        cost = cost - 1.0 * lifted
        cost = cost + 0.5 * d * lifted
        if self.add_bonus_rewards:
            cost = cost - 10.0 * (d < 0.1).to(cost.dtype)
            cost = cost - 20.0 * (d < 0.05).to(cost.dtype)
        return cost

    def state_from_observation(self, observation):
        raise NotImplementedError("Relocate planning requires GT env states")
