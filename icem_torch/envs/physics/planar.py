"""Planar articulated rigid-body dynamics: the model and its autodiff engine.

Counterpart of ``icem_tpu/envs/physics/planar.py``. The dynamics are a
function of one trajectory's ``(q, qd, ctrl)``, derived by autodiff as in the
JAX package: ``torch.func`` takes the same derivatives where JAX takes them
(``jvp`` for velocities, ``jacfwd(grad)`` for the mass matrix, a ``jvp`` of
the momentum gradient for the Coriolis bias, ``vjp`` for generalized
forces), and ``torch.func.vmap`` batches a function over trajectories. Every
function works on the device of its inputs; the model's arrays go to a
device once (``_constants``).

Formulation (Lagrangian, no hand-derived equations):

- A model is a kinematic tree of B planar bodies. Body 0 is either a free
  planar root (dofs x, z, rot) or a hinge to the world; every other body
  hangs from its parent by one hinge.
- ``fk(q)`` gives body COM positions, absolute angles and contact-point
  world positions.
- T(q, qd) comes from one ``jvp`` through fk; M = d(dT/dqd)/dqd; the bias
  h = (dp/dq) qd - dT/dq + dV/dq with p = dT/dqd.
- Ground contact: penalty springs at geom points (normal spring-damper,
  clamped-viscous Coulomb friction), mapped to generalized forces by a
  ``vjp`` of the contact-point map (virtual work).
- Integration: semi-implicit Euler, ``n_substeps`` per control step, with
  M, its implicit-damping Cholesky factor and the bias held over the step.

Who runs it: the real step of a model with ``energy_valve=True``
(``envs/planar_base.py``), the energy audit and the MuJoCo oracle
(``tools/fidelity_oracle.py``). Every other step goes through
``ops/planar_rollout.py`` (kernel B1 on the card, the row engine of
``batched.py`` on the CPU), which computes the same physics without the
valve. The model is plain numpy, shared by both engines and the kernel's
parameter packing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vjp

from icem_torch.device import indexed, on_device


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
    # end-of-step energy valve of the real env step: end-of-step velocities
    # are rescaled whenever E(q1, qd1) > E(q0, qd0) + max(W_actuator, 0) +
    # eps. Only the autodiff engine below carries it (``_control_step``); the
    # population rollouts (kernel B1, the row engine) are valveless, as the
    # JAX package's batched engine is
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


def _per_dof_np(model, arr, fill: float) -> np.ndarray:
    """Zero-length per-dof arrays (the dataclass defaults) mean 'none'."""
    a = np.asarray(arr, np.float32)
    if a.shape[0] == 0:
        a = np.full(model.ndof, fill, np.float32)
    return a


def device_constants(model, device, arrays) -> SimpleNamespace:
    """The arrays ``arrays(model)`` gives — (float32 arrays, int64 arrays),
    each a dict by name — as tensors on ``device``, made once per model and
    device in one copy each: a copy to the card inside a step would make the
    host wait for it at every step.

    Each public function of an engine fetches them before it takes a
    derivative: a tensor made inside ``grad`` or ``jvp`` belongs to that
    transform and may not be used after it. A caller that differentiates an
    engine function itself fetches them first."""
    cache = model.__dict__.setdefault("_engine_constants", {})
    device = indexed(device)
    if device not in cache:
        floats, ints = arrays(model)
        cache[device] = SimpleNamespace(
            **dict(zip(floats, on_device(list(floats.values()), device))),
            **dict(zip(ints, on_device(list(ints.values()), device, torch.int64))))
    return cache[device]


def _arrays(model: PlanarModel):
    floats = {n: np.asarray(getattr(model, n), np.float32) for n in (
        "anchor", "com", "mass", "inertia", "geom_pos", "geom_radius", "gear",
        "drag_normal", "drag_tangent", "drag_angular")}
    floats.update({n: _per_dof_np(model, getattr(model, n), fill) for n, fill in (
        ("damping", 0.0), ("stiffness", 0.0), ("springref", 0.0),
        ("limit_lo", -np.inf), ("limit_hi", np.inf))})
    floats["eye"] = np.eye(model.ndof, dtype=np.float32)
    ints = {n: np.asarray(getattr(model, n), np.int64) for n in ("geom_body", "actuator_dof")}
    return floats, ints


def _constants(model: PlanarModel, device) -> SimpleNamespace:
    """The model's arrays on ``device`` (``device_constants``)."""
    return device_constants(model, device, _arrays)


def _rots(theta):
    """[..., 2, 2] rotation matrices of the angles ``theta`` [...]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def fk(model: PlanarModel, q):
    """Forward kinematics.

    Returns (coms [B,2], angles [B], geom_points [G,2]).
    """
    k = _constants(model, q.device)
    origins, angles = [], []
    for b in range(model.nbody):
        if b == 0:
            if model.free_root:
                ang = q[2]
                orig = q[0:2] + k.anchor[0]
            else:
                ang = q[0]
                orig = k.anchor[0]
        else:
            pa = model.parent[b]
            pang, porig = angles[pa], origins[pa]
            ang = pang + q[model.dof_of_body(b)]
            orig = porig + _rots(pang) @ k.anchor[b]
        origins.append(orig)
        angles.append(ang)

    origins = torch.stack(origins)          # [B,2]
    angles = torch.stack(angles)            # [B]
    rots = _rots(angles)                    # [B,2,2]
    coms = origins + torch.einsum("bij,bj->bi", rots, k.com)

    if len(model.geom_body) > 0:
        gb = k.geom_body
        geom_pts = (torch.index_select(origins, 0, gb)
                    + torch.einsum("gij,gj->gi", torch.index_select(rots, 0, gb), k.geom_pos))
    else:
        geom_pts = torch.zeros_like(origins[:0])
    return coms, angles, geom_pts


def _pose(model: PlanarModel):
    def pose_fn(q_):
        coms, angles, _ = fk(model, q_)
        return coms, angles
    return pose_fn


def kinetic_energy(model: PlanarModel, q, qd):
    """T(q, qd) via one jvp through fk (no Jacobian materialization)."""
    k = _constants(model, q.device)
    _, (vcom, vang) = jvp(_pose(model), (q,), (qd,))
    return (0.5 * torch.sum(k.mass * torch.sum(vcom**2, dim=-1))
            + 0.5 * torch.sum(k.inertia * vang**2))


def potential_energy(model: PlanarModel, q):
    k = _constants(model, q.device)
    coms, _, _ = fk(model, q)
    return model.gravity * torch.sum(k.mass * coms[:, 1])


def mass_matrix(model: PlanarModel, q):
    """M(q) = d^2 T / dqd^2 (constant in qd)."""
    _constants(model, q.device)
    p_fn = grad(lambda v: kinetic_energy(model, q, v))
    return jacfwd(p_fn)(torch.zeros_like(q))


def bias_forces(model: PlanarModel, q, qd):
    """Coriolis/centrifugal h(q, qd) = (dp/dq) qd - dT/dq, plus gravity dV/dq."""
    _constants(model, q.device)

    def p_fn(q_):
        return grad(lambda v: kinetic_energy(model, q_, v))(qd)
    mdot_qd = jvp(p_fn, (q,), (qd,))[1]
    dT_dq = grad(lambda q_: kinetic_energy(model, q_, qd))(q)
    dV_dq = grad(lambda q_: potential_energy(model, q_))(q)
    return mdot_qd - dT_dq + dV_dq


def _clip(x, lo, hi):
    """``jnp.clip`` with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def contact_forces(model: PlanarModel, q, qd):
    """Generalized ground-contact forces via virtual work (vjp of geom map)."""
    if len(model.geom_body) == 0:
        return torch.zeros_like(q)
    k = _constants(model, q.device)

    def geom_fn(q_):
        return fk(model, q_)[2]

    pts, vel = jvp(geom_fn, (q,), (qd,))
    phi = pts[:, 1] - k.geom_radius                # signed distance to ground
    in_contact = phi < 0.0
    fn = torch.clamp(-model.contact_kp * phi - model.contact_kd * vel[:, 1], min=0.0)
    fn = torch.clamp(fn, max=model.contact_fmax)
    fn = torch.where(in_contact, fn, 0.0)
    ft = -_clip(model.friction_kt * vel[:, 0], -model.friction_mu * fn,
                model.friction_mu * fn)
    force = torch.stack([ft, fn], dim=-1)          # [G,2]
    return vjp(geom_fn, q)[1](force)[0]


def fluid_drag_forces(model: PlanarModel, q, qd):
    """Anisotropic viscous drag (swimmer-style fluid model).

    Each body feels a force at its COM proportional to the COM velocity,
    decomposed in the body frame, plus rotational damping. Generalized
    forces via virtual work (vjp), like contacts.
    """
    if len(model.drag_normal) == 0:
        return torch.zeros_like(q)
    k = _constants(model, q.device)
    pose_fn = _pose(model)
    (coms, angles), (vcom, vang) = jvp(pose_fn, (q,), (qd,))
    tangent = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)   # [B,2]
    normal = torch.stack([-torch.sin(angles), torch.cos(angles)], dim=-1)
    vt = torch.sum(vcom * tangent, dim=-1, keepdim=True)
    vn = torch.sum(vcom * normal, dim=-1, keepdim=True)
    f_com = -(k.drag_tangent[:, None] * vt * tangent
              + k.drag_normal[:, None] * vn * normal)                      # [B,2]
    torque = -k.drag_angular * vang                                        # [B]
    return vjp(pose_fn, q)[1]((f_com, torque))[0]


def spring_forces(model: PlanarModel, q):
    """Position-dependent passive torques: joint springs + limit penalties.

    Velocity-dependent damping is handled IMPLICITLY in the integrator
    (see ``substep``) for unconditional stability with stiff joints.
    """
    k = _constants(model, q.device)
    tau = -k.stiffness * (q - k.springref)
    over = torch.clamp(q - k.limit_hi, min=0.0)
    under = torch.clamp(k.limit_lo - q, min=0.0)
    return tau + (-model.limit_stiffness * over + model.limit_stiffness * under)


def damping_diagonal(model: PlanarModel, q):
    """Per-dof viscous coefficients treated implicitly: joint damping plus
    extra limit damping while a limit is violated."""
    k = _constants(model, q.device)
    in_violation = (q > k.limit_hi) | (q < k.limit_lo)
    return k.damping + torch.where(in_violation, model.limit_damping, 0.0)


def actuation(model: PlanarModel, ctrl):
    """Map [A] controls to [ndof] torques (torque = gear * ctrl)."""
    k = _constants(model, ctrl.device)
    tau = ctrl.new_zeros(model.ndof)
    if len(model.actuator_dof) == 0:
        return tau
    return tau.index_add(0, k.actuator_dof, k.gear * ctrl)


def substep(model: PlanarModel, q, qd, tau_ctrl, dt_sub: float):
    """One semi-implicit Euler substep with implicit joint damping.

    Solving (M + dt*D) qd' = M qd + dt * rhs makes arbitrarily large joint
    damping unconditionally stable; contact normal/friction damping stays
    explicit but is tuned against the substep size.
    """
    k = _constants(model, q.device)
    rhs = (tau_ctrl + spring_forces(model, q) + contact_forces(model, q, qd)
           + fluid_drag_forces(model, q, qd) - bias_forces(model, q, qd))
    M = mass_matrix(model, q) + 1e-6 * k.eye
    D = damping_diagonal(model, q)
    lhs = M + dt_sub * torch.diag_embed(D)
    qd_new = torch.linalg.solve(lhs, M @ qd + dt_sub * rhs)
    qd_new = torch.clamp(qd_new, -model.max_qd, model.max_qd)  # safety rail
    return q + dt_sub * qd_new, qd_new


def cholesky_unrolled(A, n: int):
    """Cholesky factor of a small SPD matrix, fully unrolled.

    Returns the lower factor as nested lists of (batched) scalars.
    """
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                # pivot floor RELATIVE to the diagonal: near a singular
                # configuration (rpy gimbal lock) f32 roundoff drives the
                # Schur complement to ~eps*A_ii; an absolute 1e-9 floor
                # makes 1/L ~ 3e4, and the back-substitution's alternating
                # huge products overflow to inf - inf = nan over ~14 dofs.
                # Flooring at 1e-5*A_ii bounds the amplification — the lost
                # dof direction gets extra inertia (bounded acceleration)
                # instead of a NaN'd state; well-conditioned steps never
                # reach the floor.
                L[i][j] = torch.sqrt(torch.maximum(
                    s, torch.clamp(1e-5 * A[..., i, i], min=1e-9)))
            else:
                L[i][j] = s / L[j][j]
    return L


def cholesky_solve_unrolled(L, b, n: int):
    """Solve L L^T x = b with the unrolled factor from cholesky_unrolled."""
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def contact_energy(model, depth):
    """Elastic energy of the penalty contacts at penetration ``depth`` [G]:
    piecewise, consistent with the fmax-capped normal spring — quadratic
    below pen* = fmax/kp, linear (constant force) beyond. With fmax = inf the
    linear branch would be inf * 0 = nan, so it exists only for finite caps."""
    pen = torch.clamp(depth, min=0.0)
    if np.isfinite(model.contact_fmax):
        pen_star = model.contact_fmax / model.contact_kp
        quad = 0.5 * model.contact_kp * torch.clamp(pen, max=pen_star) ** 2
        lin = model.contact_fmax * torch.clamp(pen - pen_star, min=0.0)
        return torch.sum(quad + lin)
    return torch.sum(0.5 * model.contact_kp * pen**2)


def stored_energy(model: PlanarModel, q, qd):
    """Total mechanical energy the state can release: kinetic + gravity PE +
    joint-spring PE + limit-spring PE + contact-spring PE.

    Every term the integrator can convert back into motion is included, so
    the physical inequality dE/dt <= P_actuator holds exactly for the
    continuous dynamics (joint damping, Coulomb friction, fluid drag and the
    contact normal damper only remove energy). The energy audit
    (``step_with_energy_audit``) and the valve bound a step's growth by it.
    """
    k = _constants(model, q.device)
    e = kinetic_energy(model, q, qd) + potential_energy(model, q)
    e = e + 0.5 * torch.sum(k.stiffness * (q - k.springref) ** 2)
    over = torch.clamp(q - k.limit_hi, min=0.0)
    under = torch.clamp(k.limit_lo - q, min=0.0)
    e = e + 0.5 * model.limit_stiffness * torch.sum(over**2 + under**2)
    if len(model.geom_body) > 0:
        pts = fk(model, q)[2]
        e = e + contact_energy(model, k.geom_radius - pts[:, 1])
    return e


def _valve(model, stored, kinetic, q, qd, q_new, qd_new, w_act):
    """End-of-step velocities rescaled so E1 <= E0 + max(W, 0) + eps (all the
    removable energy is kinetic; the potential terms depend on q alone). With
    no excess the scale clips to exactly 1.0, so a nominal step is
    bit-identical to the valveless integrator."""
    bound = stored(model, q, qd) + torch.clamp(w_act, min=0.0) + model.energy_valve_eps
    e1 = stored(model, q_new, qd_new)
    ke1 = kinetic(model, q_new, qd_new)
    excess = e1 - bound
    scale2 = torch.clamp((ke1 - excess) / torch.clamp(ke1, min=1e-9), 0.0, 1.0)
    return qd_new * torch.sqrt(scale2)


def _control_step(model: PlanarModel, q, qd, ctrl, with_work: bool):
    """Shared control-step body; ``with_work`` additionally integrates the
    exact discrete actuator work sum(tau . qd_new * dt_sub) for the energy
    audit (the model's energy valve needs it too)."""
    with_work = with_work or model.energy_valve
    n = model.ndof
    k = _constants(model, q.device)
    tau_ctrl = actuation(model, ctrl)
    dt_sub = model.dt / model.n_substeps

    M = mass_matrix(model, q) + 1e-6 * k.eye
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
               + contact_forces(model, q_, qd_)
               + fluid_drag_forces(model, q_, qd_) - bias)
        qd_new = cholesky_solve_unrolled(L, M @ qd_ + dt_sub * rhs, n)
        qd_new = torch.clamp(qd_new, -model.max_qd, model.max_qd)
        q_ = q_ + dt_sub * qd_new
        qd_ = qd_new
        if with_work:
            work = work + dt_sub * torch.dot(tau, qd_new)

    if model.energy_valve:
        qd_ = _valve(model, stored_energy, kinetic_energy, q, qd, q_, qd_, work)
    return q_, qd_, (work if with_work else None)


def step(model: PlanarModel, q, qd, ctrl):
    """One control step = n_substeps physics substeps.

    The mass matrix, its implicit-damping Cholesky factor and the
    Coriolis/gravity bias are computed ONCE per control step and held over
    the substeps; per substep only the stiff terms — contact, spring/limit
    and drag forces — are re-evaluated.
    """
    q_new, qd_new, _ = _control_step(model, q, qd, ctrl, with_work=False)
    return q_new, qd_new


def step_with_energy_audit(model: PlanarModel, q, qd, ctrl):
    """Control step that also returns the exact discrete actuator work.

    (q2, qd2, w_act) — the audit quantity is
    stored_energy(q2, qd2) - stored_energy(q, qd) - max(w_act, 0), which a
    leak-free discrete integrator keeps <= a small epsilon.
    """
    return _control_step(model, q, qd, ctrl, with_work=True)


def chain_link_inertia(mass: float, length: float) -> float:
    """Thin-rod moment of inertia about the COM."""
    return mass * length**2 / 12.0
