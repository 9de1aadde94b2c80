"""Static description of a spatial (3D) articulated rigid-body tree.

Counterpart of the ``SpatialModel`` dataclass of
``icem_tpu/envs/physics/spatial.py``. The port keeps only the model here:
every population step, the real env step included, goes through
``ops/spatial_rollout.py`` (the CUDA kernel on the card, the row engine of
``spatial_batched.py`` on the CPU). The model is plain numpy, so it is shared
by the kernel's parameter packing and the row engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SpatialModel:
    """Static description of a 3D kinematic tree.

    Body 0 is the root. If ``free_root`` the dof layout is
    ``[x, y, z, roll, pitch, yaw, hinge_1 .. hinge_{B-1}]`` (dof of body
    b>0 is ``5 + b``), else every body including the root has one hinge
    (dof of body b is ``b``). Parents precede their children.
    """

    parent: Tuple[int, ...]          # per body; parent[0] == -1
    anchor: np.ndarray               # [B,3] joint anchor in parent frame
    axis: np.ndarray                 # [B,3] hinge axis in body frame (unit)
    com: np.ndarray                  # [B,3] COM offset in body frame
    mass: np.ndarray                 # [B]
    inertia: np.ndarray              # [B,3] diagonal inertia about COM, body frame
    free_root: bool = True
    # constant world-frame rotation LEFT of the root rpy chart:
    # R_root = root_rot_offset @ Rz(yaw) Ry(pitch) Rx(roll). It moves the
    # chart's singularity (pitch = +-pi/2) away from a task's working range.
    root_rot_offset: np.ndarray = field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    # contact geoms: spheres attached to bodies
    geom_body: Tuple[int, ...] = ()
    geom_pos: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    geom_radius: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # actuators: torque = gear * ctrl applied to a dof
    actuator_dof: Tuple[int, ...] = ()
    gear: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # per-dof passive dynamics (zero-length = none)
    damping: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    stiffness: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    springref: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_lo: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_hi: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_stiffness: float = 400.0
    limit_damping: float = 4.0
    # world
    gravity: float = 9.81
    contact_kp: float = 2.0e4
    contact_kd: float = 200.0
    contact_fmax: float = np.inf
    friction_mu: float = 1.0
    friction_kt: float = 400.0
    # scalar or per-dof [ndof] velocity clip
    max_qd: float | np.ndarray = 100.0
    # DC-motor speed-torque line (inf disables)
    motor_omega_max: float = np.inf
    # energy-consistency valve: end-of-step velocities are rescaled whenever
    # E(q1, qd1) > E(q0, qd0) + max(W_actuator, 0) + eps
    energy_valve: bool = False
    energy_valve_eps: float = 0.1
    # integration
    dt: float = 0.05
    n_substeps: int = 10

    @property
    def nbody(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return (6 + self.nbody - 1) if self.free_root else self.nbody

    def dof_of_body(self, b: int) -> int:
        """The hinge dof index of body b (b > 0 for free_root models)."""
        return (5 + b) if self.free_root else b
