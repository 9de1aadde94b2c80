"""Static description of a planar articulated rigid-body tree.

The port keeps only the model here: every population step, the real env
step included, goes through ``ops/planar_rollout.py`` (the CUDA kernel on
the card, the row engine of ``batched.py`` on the CPU). The model is plain
numpy, so it is shared by the kernel's parameter packing and the row engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class PlanarModel:
    """Static description of a planar kinematic tree.

    Body 0 is the root. If ``free_root`` the dof layout is
    ``[x, z, rot, hinge_1 .. hinge_{B-1}]`` (dof of body b>0 is ``2 + b``),
    else every body including the root has one hinge
    (dof of body b is ``b``). Parents precede their children.
    """

    parent: Tuple[int, ...]          # per body; parent[0] == -1
    anchor: np.ndarray               # [B,2] joint anchor in parent frame
    com: np.ndarray                  # [B,2] COM offset in body frame
    mass: np.ndarray                 # [B]
    inertia: np.ndarray              # [B] about COM
    free_root: bool = True
    # contact geoms: spheres attached to bodies
    geom_body: Tuple[int, ...] = ()
    geom_pos: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    geom_radius: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # actuators: torque = gear * ctrl applied to a dof
    actuator_dof: Tuple[int, ...] = ()
    gear: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # per-dof passive dynamics
    damping: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    stiffness: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    springref: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_lo: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_hi: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    limit_stiffness: float = 400.0
    limit_damping: float = 4.0
    # anisotropic viscous fluid drag per body (zero-length = disabled)
    drag_normal: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    drag_tangent: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    drag_angular: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    # world
    gravity: float = 9.81
    contact_kp: float = 2.0e4
    contact_kd: float = 200.0
    contact_fmax: float = np.inf     # cap on the penalty contact's normal force
    friction_mu: float = 1.0
    friction_kt: float = 400.0
    max_qd: float = 100.0            # hard velocity rail (numerical safety)
    # DC-motor speed-torque line: available torque falls linearly to zero at
    # |qd| = motor_omega_max in the torque direction (inf disables)
    motor_omega_max: float = np.inf
    # end-of-step energy valve of the real env step; the port does not carry
    # it (envs/planar_base.py raises for a model that turns it on)
    energy_valve: bool = False
    energy_valve_eps: float = 0.1
    # integration
    dt: float = 0.05                 # control timestep
    n_substeps: int = 10

    @property
    def nbody(self) -> int:
        return len(self.parent)

    @property
    def ndof(self) -> int:
        return (3 + self.nbody - 1) if self.free_root else self.nbody

    def dof_of_body(self, b: int) -> int:
        """The hinge dof index of body b (b > 0 for free_root models)."""
        return (2 + b) if self.free_root else b


def chain_link_inertia(mass: float, length: float) -> float:
    """Thin-rod moment of inertia about the COM."""
    return mass * length**2 / 12.0
