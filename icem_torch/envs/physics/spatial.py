"""Spatial (3D) articulated rigid-body dynamics: the model and its autodiff
engine.

Counterpart of ``icem_tpu/envs/physics/spatial.py``. The engine mirrors
``planar.py`` one function for one function — fk -> kinetic energy via one
jvp -> mass matrix via jacfwd(grad) -> bias via jvp + grad -> contacts via
jvp + vjp -> semi-implicit Euler with an unrolled Cholesky — written per
trajectory with ``torch.func`` and batched with ``torch.func.vmap``.

3D-specific choices:

- Root orientation is intrinsic roll-pitch-yaw: R = Rz(yaw) Ry(pitch)
  Rx(roll), q[3:6] = [roll, pitch, yaw], left-multiplied by the model's
  constant ``root_rot_offset``.
- Every non-root joint is a hinge about a fixed body-frame axis (Rodrigues
  rotation).
- Body angular velocity comes out of the same jvp that gives COM
  velocities: Omega = unhat(R^T Rdot), and T_rot = 1/2 Omega . (I_body *
  Omega) with the diagonal body-frame inertia.
- Ground contact is sphere-vs-plane z=0: normal spring-damper along z,
  Coulomb friction clamps the 2-norm of the (x, y) tangential viscous force
  to mu * fn.

Every population step, the real env step included, goes through
``ops/spatial_rollout.py`` (kernel B2 on the card, the row engine of
``spatial_batched.py`` on the CPU), which computes the same physics with the
valve; this engine serves the MuJoCo oracle (``tools/fidelity_oracle.py``)
and the checks that hold the two engines together. The model is plain
numpy, shared by the engines and the kernel's parameter packing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vjp

from icem_torch.envs.physics.planar import (_per_dof_np, _valve, cholesky_solve_unrolled,
                                            cholesky_unrolled, contact_energy,
                                            device_constants)


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


def _skew(axis) -> np.ndarray:
    a = np.asarray(axis, np.float32)
    return np.array([[0.0, -a[2], a[1]],
                     [a[2], 0.0, -a[0]],
                     [-a[1], a[0], 0.0]], np.float32)


def _arrays(model: SpatialModel):
    """The model's arrays, each hinge's skew matrix K and K @ K among them."""
    skews = np.stack([_skew(a) for a in np.asarray(model.axis, np.float32)])
    floats = {n: np.asarray(getattr(model, n), np.float32) for n in (
        "anchor", "com", "mass", "inertia", "root_rot_offset", "geom_pos", "geom_radius",
        "gear", "max_qd")}
    floats.update({n: _per_dof_np(model, getattr(model, n), fill) for n, fill in (
        ("damping", 0.0), ("stiffness", 0.0), ("springref", 0.0),
        ("limit_lo", -np.inf), ("limit_hi", np.inf))})
    floats.update(K=skews, KK=skews @ skews, eye=np.eye(3, dtype=np.float32),
                  eye_n=np.eye(model.ndof, dtype=np.float32))
    ints = {n: np.asarray(getattr(model, n), np.int64) for n in ("geom_body", "actuator_dof")}
    return floats, ints


def _constants(model: SpatialModel, device) -> SimpleNamespace:
    """The model's arrays on ``device`` (``planar.device_constants``)."""
    return device_constants(model, device, _arrays)


def _rodrigues(K, KK, eye, theta):
    s, c = torch.sin(theta), torch.cos(theta)
    return eye + s * K + (1.0 - c) * KK


def _rot_axis(axis, theta):
    """Rodrigues rotation about a fixed unit axis (a host array; ``fk``
    takes each hinge's K and K @ K from the model's device constants)."""
    K = torch.as_tensor(_skew(axis), device=theta.device)
    return _rodrigues(K, K @ K, torch.eye(3, device=theta.device), theta)


def _mat3(*entries):
    return torch.stack(entries).reshape(3, 3)


def _rot_rpy(rpy):
    """Intrinsic roll-pitch-yaw: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = torch.cos(rpy[0]), torch.sin(rpy[0])
    cp, sp = torch.cos(rpy[1]), torch.sin(rpy[1])
    cy, sy = torch.cos(rpy[2]), torch.sin(rpy[2])
    one, zero = torch.ones_like(cr), torch.zeros_like(cr)
    Rx = _mat3(one, zero, zero, zero, cr, -sr, zero, sr, cr)
    Ry = _mat3(cp, zero, sp, zero, one, zero, -sp, zero, cp)
    Rz = _mat3(cy, -sy, zero, sy, cy, zero, zero, zero, one)
    return Rz @ Ry @ Rx


def fk(model: SpatialModel, q):
    """Forward kinematics.

    Returns (coms [B,3], rotations [B,3,3], geom_points [G,3]).
    """
    k = _constants(model, q.device)
    origins, rots = [], []
    for b in range(model.nbody):
        if b == 0:
            if model.free_root:
                R = k.root_rot_offset @ _rot_rpy(q[3:6])
                orig = q[0:3] + k.anchor[0]
            else:
                R = _rodrigues(k.K[0], k.KK[0], k.eye, q[0])
                orig = k.anchor[0]
        else:
            pa = model.parent[b]
            Rp, op = rots[pa], origins[pa]
            R = Rp @ _rodrigues(k.K[b], k.KK[b], k.eye, q[model.dof_of_body(b)])
            orig = op + Rp @ k.anchor[b]
        origins.append(orig)
        rots.append(R)

    origins = torch.stack(origins)                     # [B,3]
    rots = torch.stack(rots)                           # [B,3,3]
    coms = origins + torch.einsum("bij,bj->bi", rots, k.com)

    if len(model.geom_body) > 0:
        gb = k.geom_body
        geom_pts = (torch.index_select(origins, 0, gb)
                    + torch.einsum("gij,gj->gi", torch.index_select(rots, 0, gb), k.geom_pos))
    else:
        geom_pts = torch.zeros_like(origins[:0])
    return coms, rots, geom_pts


def _unhat(A):
    """Vector of a skew-symmetric [...,3,3] matrix."""
    return torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], dim=-1)


def kinetic_energy(model: SpatialModel, q, qd):
    """T(q, qd) via one jvp through fk.

    The rotation tangents Rdot give body-frame angular velocities
    Omega = unhat(R^T Rdot); inertia stays diagonal in the body frame, so
    T_rot never forms a world inertia tensor.
    """
    k = _constants(model, q.device)

    def pose_fn(q_):
        coms, rots, _ = fk(model, q_)
        return coms, rots

    (_, rots), (vcom, rdot) = jvp(pose_fn, (q,), (qd,))
    omega = _unhat(torch.einsum("bji,bjk->bik", rots, rdot))   # R^T Rdot
    t_lin = 0.5 * torch.sum(k.mass * torch.sum(vcom**2, dim=-1))
    t_rot = 0.5 * torch.sum(k.inertia * omega**2)
    return t_lin + t_rot


def potential_energy(model: SpatialModel, q):
    k = _constants(model, q.device)
    coms, _, _ = fk(model, q)
    return model.gravity * torch.sum(k.mass * coms[:, 2])


def mass_matrix(model: SpatialModel, q):
    """M(q) = d^2 T / dqd^2 (constant in qd)."""
    _constants(model, q.device)
    p_fn = grad(lambda v: kinetic_energy(model, q, v))
    return jacfwd(p_fn)(torch.zeros_like(q))


def bias_forces(model: SpatialModel, q, qd):
    """Coriolis/centrifugal h(q, qd) = (dp/dq) qd - dT/dq, plus gravity dV/dq."""
    _constants(model, q.device)

    def p_fn(q_):
        return grad(lambda v: kinetic_energy(model, q_, v))(qd)
    mdot_qd = jvp(p_fn, (q,), (qd,))[1]
    dT_dq = grad(lambda q_: kinetic_energy(model, q_, qd))(q)
    dV_dq = grad(lambda q_: potential_energy(model, q_))(q)
    return mdot_qd - dT_dq + dV_dq


def contact_forces(model: SpatialModel, q, qd):
    """Generalized ground-contact forces via virtual work (vjp of geom map).

    Normal: spring-damper along +z, capped at contact_fmax. Friction:
    viscous in the (x, y) tangent plane with its 2-NORM clamped to
    mu * fn (isotropic Coulomb cone).
    """
    if len(model.geom_body) == 0:
        return torch.zeros_like(q)
    k = _constants(model, q.device)

    def geom_fn(q_):
        return fk(model, q_)[2]

    pts, vel = jvp(geom_fn, (q,), (qd,))
    phi = pts[:, 2] - k.geom_radius
    in_contact = phi < 0.0
    fn = torch.clamp(-model.contact_kp * phi - model.contact_kd * vel[:, 2], min=0.0)
    fn = torch.clamp(fn, max=model.contact_fmax)
    fn = torch.where(in_contact, fn, 0.0)
    ft_raw = -model.friction_kt * vel[:, :2]                  # [G,2]
    ft_norm = torch.linalg.vector_norm(ft_raw, dim=-1)
    scale = torch.clamp(model.friction_mu * fn / torch.clamp(ft_norm, min=1e-9), max=1.0)
    ft = ft_raw * scale[:, None]
    force = torch.cat([ft, fn[:, None]], dim=-1)              # [G,3]
    return vjp(geom_fn, q)[1](force)[0]


def spring_forces(model: SpatialModel, q):
    """Position-dependent passive torques: joint springs + limit penalties."""
    k = _constants(model, q.device)
    tau = -k.stiffness * (q - k.springref)
    over = torch.clamp(q - k.limit_hi, min=0.0)
    under = torch.clamp(k.limit_lo - q, min=0.0)
    return tau + (-model.limit_stiffness * over + model.limit_stiffness * under)


def damping_diagonal(model: SpatialModel, q):
    """Per-dof viscous coefficients (implicit): joint damping + limit damping."""
    k = _constants(model, q.device)
    in_violation = (q > k.limit_hi) | (q < k.limit_lo)
    return k.damping + torch.where(in_violation, model.limit_damping, 0.0)


def stored_energy(model: SpatialModel, q, qd):
    """Total mechanical energy the state can release: kinetic + gravity PE +
    joint-spring PE + limit-spring PE + contact-spring PE.

    Every term the integrator can convert back into motion is included, so
    the physical inequality dE/dt <= P_actuator holds exactly for the
    continuous dynamics — the energy_valve enforces its discrete analog.
    """
    k = _constants(model, q.device)
    e = kinetic_energy(model, q, qd) + potential_energy(model, q)
    e = e + 0.5 * torch.sum(k.stiffness * (q - k.springref) ** 2)
    over = torch.clamp(q - k.limit_hi, min=0.0)
    under = torch.clamp(k.limit_lo - q, min=0.0)
    e = e + 0.5 * model.limit_stiffness * torch.sum(over**2 + under**2)
    if len(model.geom_body) > 0:
        pts = fk(model, q)[2]
        e = e + contact_energy(model, k.geom_radius - pts[:, 2])
    return e


def actuation(model: SpatialModel, ctrl):
    """Map [A] controls to [ndof] torques (torque = gear * ctrl)."""
    k = _constants(model, ctrl.device)
    tau = ctrl.new_zeros(model.ndof)
    if len(model.actuator_dof) == 0:
        return tau
    return tau.index_add(0, k.actuator_dof, k.gear * ctrl)


def step(model: SpatialModel, q, qd, ctrl):
    """One control step = n_substeps semi-implicit Euler substeps.

    Same split as planar.step: mass matrix + implicit-damping Cholesky +
    Coriolis/gravity bias once per control step (smooth terms); only the
    stiff contact and spring/limit forces re-evaluate per substep.
    """
    n = model.ndof
    k = _constants(model, q.device)
    tau_ctrl = actuation(model, ctrl)
    dt_sub = model.dt / model.n_substeps

    M = mass_matrix(model, q) + 1e-6 * k.eye_n
    D = damping_diagonal(model, q)
    lhs = M + dt_sub * torch.diag_embed(D)
    L = cholesky_unrolled(lhs, n)
    bias = bias_forces(model, q, qd)

    q_, qd_, work = q, qd, torch.zeros_like(q[0])
    for _ in range(model.n_substeps):
        if np.isfinite(model.motor_omega_max):
            speed_factor = torch.clamp(
                1.0 - qd_ * torch.sign(tau_ctrl) / model.motor_omega_max, 0.0, 1.0)
            tau = tau_ctrl * speed_factor
        else:
            tau = tau_ctrl
        rhs = (tau + spring_forces(model, q_)
               + contact_forces(model, q_, qd_) - bias)
        qd_new = cholesky_solve_unrolled(L, M @ qd_ + dt_sub * rhs, n)
        qd_new = torch.minimum(torch.maximum(qd_new, -k.max_qd), k.max_qd)
        q_ = q_ + dt_sub * qd_new
        qd_ = qd_new
        # discrete actuator work (torque through the displacement it caused)
        work = work + dt_sub * torch.dot(tau, qd_new)

    if model.energy_valve:
        qd_ = _valve(model, stored_energy, kinetic_energy, q, qd, q_, qd_, work)
    return q_, qd_
