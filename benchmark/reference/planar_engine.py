"""Frozen plain planar physics: the row engine and the HalfCheetah model.

A verbatim copy, frozen for the benchmark, of the port's plain planar
version (its ``PlanarModel``, its population row engine, its horizon loop
and its HalfCheetah model), so that the comparison that decides a run's
``correct`` does not move when the program does. It imports nothing of the
program. Every physical scalar is one ``[P]`` row; ``step_rows`` is one
control step of ``n_substeps`` semi-implicit Euler substeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch


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

def _floats(arr, n: int | None = None, fill: float = 0.0) -> list:
    """A model array as Python floats; zero-length (the default) -> fill."""
    a = np.asarray(arr, np.float64).reshape(-1)
    if a.shape[0] == 0 and n is not None:
        a = np.full(n, fill)
    return a.tolist()


def _ancestors(model: PlanarModel):
    """For each body, the chain of bodies from root to itself (inclusive)."""
    chains = []
    for b in range(model.nbody):
        chain, c = [], b
        while c != -1:
            chain.append(c)
            c = model.parent[c]
        chains.append(list(reversed(chain)))
    return chains


def _hinge_ancestors(model: PlanarModel, chains):
    """Per body: [(dof_j, joint_body_c), ...] — rotational dofs on the chain.

    Column j of any point-Jacobian on body b is perp(p - o_c) for each such
    pair. Free roots contribute the root-rotation dof (2) about the root
    origin; hinge roots make every chain body (root included) a hinge."""
    out = []
    for b in range(model.nbody):
        if model.free_root:
            out.append([(2, 0)] + [(model.dof_of_body(c), c)
                                   for c in chains[b] if c != 0])
        else:
            out.append([(model.dof_of_body(c), c) for c in chains[b]])
    return out


def _fk_core(model: PlanarModel, q):
    """q: list of ndof rows -> per-body lists (ox, oz, cs, sn)."""
    anchors = np.asarray(model.anchor, np.float64).tolist()
    ox, oz, ang, cs, sn = [], [], [], [], []
    for b in range(model.nbody):
        if b == 0:
            if model.free_root:
                a = q[2]
                x = q[0] + anchors[0][0]
                z = q[1] + anchors[0][1]
            else:
                # world-fixed hinge root: the origin is a constant
                a = q[0]
                x = anchors[0][0]
                z = anchors[0][1]
        else:
            pa = model.parent[b]
            a = ang[pa] + q[model.dof_of_body(b)]
            x = ox[pa] + cs[pa] * anchors[b][0] - sn[pa] * anchors[b][1]
            z = oz[pa] + sn[pa] * anchors[b][0] + cs[pa] * anchors[b][1]
        ox.append(x)
        oz.append(z)
        ang.append(a)
        cs.append(torch.cos(a))
        sn.append(torch.sin(a))
    return ox, oz, cs, sn


def _fk_batched(model: PlanarModel, q):
    """Per-body origins and per-geom world points."""
    ox, oz, cs, sn = _fk_core(model, q)
    gpos = np.asarray(model.geom_pos, np.float64).tolist()
    px, pz = [], []
    for g, b in enumerate(model.geom_body):
        px.append(ox[b] + cs[b] * gpos[g][0] - sn[b] * gpos[g][1])
        pz.append(oz[b] + sn[b] * gpos[g][0] + cs[b] * gpos[g][1])
    return ox, oz, px, pz


def mass_bias_batched(model: PlanarModel, q, qd, chains=None):
    """Hand-derived batched mass matrix and bias (Coriolis + gravity).

    - M_ij  = sum_b m_b <J^com_b_i, J^com_b_j> + I_b [i,j both hinge anc]
    - grav_j = g * sum_b m_b d(com_b_z)/dq_j
    - Coriolis_i = sum_b m_b <J^com_b_i, a_b> with the velocity-product
      acceleration a_b = sum_(j,c) qd_j * perp(v_com_b - v_{o_c}).

    Returns (M [i][j] full symmetric lists, bias list of ndof rows).
    """
    n = model.ndof
    chains = chains if chains is not None else _ancestors(model)
    hinges = _hinge_ancestors(model, chains)
    mass = _floats(model.mass)
    inertia = _floats(model.inertia)
    com_l = np.asarray(model.com, np.float64).tolist()
    ox, oz, cs, sn = _fk_core(model, q)

    # COM positions and their Jacobian hinge columns perp(com - o_c)
    cx = [ox[b] + cs[b] * com_l[b][0] - sn[b] * com_l[b][1]
          for b in range(model.nbody)]
    cz = [oz[b] + sn[b] * com_l[b][0] + cs[b] * com_l[b][1]
          for b in range(model.nbody)]

    # per body: J columns as [(dof, jx, jz), ...]; free-root translations are
    # identity constants, hinge roots have rotational columns only
    free = bool(model.free_root)
    cols = []
    for b in range(model.nbody):
        c_b = [(0, 1.0, 0.0), (1, 0.0, 1.0)] if free else []
        for j, c in hinges[b]:
            c_b.append((j, -(cz[b] - oz[c]), cx[b] - ox[c]))
        cols.append(c_b)

    # ---- mass matrix (lower triangle, mirrored) ----------------------------
    M = [[0.0] * n for _ in range(n)]
    for b in range(model.nbody):
        m_b = mass[b]
        for a_i, (i, aix, aiz) in enumerate(cols[b]):
            for (j, ajx, ajz) in cols[b][: a_i + 1]:
                lo, hi = (j, i) if i >= j else (i, j)
                M[hi][lo] = M[hi][lo] + m_b * (aix * ajx + aiz * ajz)
        hdofs = [j for j, _ in hinges[b]]
        for a_i, i in enumerate(hdofs):
            for j in hdofs[: a_i + 1]:
                lo, hi = (j, i) if i >= j else (i, j)
                M[hi][lo] = M[hi][lo] + inertia[b]
    for i in range(n):
        for j in range(i):
            M[j][i] = M[i][j]

    # ---- velocities of joint origins and COMs ------------------------------
    def point_vel(px_, pz_, hinge_list):
        vx, vz = (qd[0], qd[1]) if free else (0.0, 0.0)
        for j, c in hinge_list:
            vx = vx - qd[j] * (pz_ - oz[c])
            vz = vz + qd[j] * (px_ - ox[c])
        return vx, vz

    vox, voz = [], []
    for b in range(model.nbody):
        if b == 0:
            # free root: origin rides the translation dofs; hinge root: fixed
            vox.append(qd[0] if free else 0.0)
            voz.append(qd[1] if free else 0.0)
        else:
            # the joint pivot moves with the PARENT body's chain
            vx, vz = point_vel(ox[b], oz[b], hinges[model.parent[b]])
            vox.append(vx)
            voz.append(vz)

    # ---- bias: Coriolis/centrifugal + gravity ------------------------------
    bias = [0.0] * n
    g = float(model.gravity)
    for b in range(model.nbody):
        m_b = mass[b]
        vcx, vcz = point_vel(cx[b], cz[b], hinges[b])
        ax, az = 0.0, 0.0
        for j, c in hinges[b]:
            ax = ax - qd[j] * (vcz - voz[c])
            az = az + qd[j] * (vcx - vox[c])
        if free:
            bias[0] = bias[0] + m_b * ax
            bias[1] = bias[1] + m_b * (az + g)  # gravity: dV/dq_z = g * m_b
        for j, c in hinges[b]:
            jx = -(cz[b] - oz[c])
            jz = cx[b] - ox[c]
            bias[j] = bias[j] + m_b * (jx * ax + jz * (az + g))
    return M, bias


def _contact_tau(model: PlanarModel, q, qd, chains):
    """Generalized penalty-contact forces as ndof rows.

    For hinge dof j (joint at body c's origin o_c) a geom point's Jacobian
    column is perp(p - o_c); root translations contribute identity columns.
    Velocities are J qd, generalized forces J^T f.
    """
    ox, oz, px, pz = _fk_batched(model, q)
    radius = _floats(model.geom_radius)
    all_hinges = _hinge_ancestors(model, chains)
    free = bool(model.free_root)
    kp, kd = float(model.contact_kp), float(model.contact_kd)
    fmax, mu, kt = float(model.contact_fmax), float(model.friction_mu), float(model.friction_kt)
    tau = [0.0] * model.ndof
    for g, b in enumerate(model.geom_body):
        hinges = all_hinges[b]
        vx, vz = (qd[0], qd[1]) if free else (0.0, 0.0)
        for j, c in hinges:
            dx = px[g] - ox[c]
            dz = pz[g] - oz[c]
            vx = vx - qd[j] * dz
            vz = vz + qd[j] * dx
        phi = pz[g] - radius[g]
        fn = torch.clamp(-kp * phi - kd * vz, min=0.0)
        fn = torch.clamp(fn, max=fmax)
        fn = torch.where(phi < 0.0, fn, 0.0)
        ft = -torch.clamp(kt * vx, min=-mu * fn, max=mu * fn)
        if free:
            tau[0] = tau[0] + ft
            tau[1] = tau[1] + fn
        for j, c in hinges:
            dx = px[g] - ox[c]
            dz = pz[g] - oz[c]
            tau[j] = tau[j] + (-dz * ft + dx * fn)
    return tau


def _drag_tau(model: PlanarModel, q, qd, chains):
    """Anisotropic viscous fluid drag as ndof rows: a COM force decomposed in
    the body frame (tangent (cs, sn), normal (-sn, cs)) plus rotational
    damping, through the COM point-Jacobian columns."""
    cn = _floats(model.drag_normal)
    ct = _floats(model.drag_tangent)
    ca = _floats(model.drag_angular)
    hinges_all = _hinge_ancestors(model, chains)
    com_l = np.asarray(model.com, np.float64).tolist()
    free = bool(model.free_root)
    ox, oz, cs, sn = _fk_core(model, q)

    tau = [0.0] * model.ndof
    for b in range(model.nbody):
        hinges = hinges_all[b]
        cx = ox[b] + cs[b] * com_l[b][0] - sn[b] * com_l[b][1]
        cz = oz[b] + sn[b] * com_l[b][0] + cs[b] * com_l[b][1]
        vcx, vcz = (qd[0], qd[1]) if free else (0.0, 0.0)
        vang = 0.0
        for j, c in hinges:
            vcx = vcx - qd[j] * (cz - oz[c])
            vcz = vcz + qd[j] * (cx - ox[c])
            vang = vang + qd[j]
        vt = vcx * cs[b] + vcz * sn[b]
        vn = -vcx * sn[b] + vcz * cs[b]
        fx = -(ct[b] * vt * cs[b] - cn[b] * vn * sn[b])
        fz = -(ct[b] * vt * sn[b] + cn[b] * vn * cs[b])
        torque = -ca[b] * vang
        if free:
            tau[0] = tau[0] + fx
            tau[1] = tau[1] + fz
        for j, c in hinges:
            jx = -(cz - oz[c])
            jz = cx - ox[c]
            tau[j] = tau[j] + jx * fx + jz * fz + torque
    return tau


def _spring_tau(model: PlanarModel, q):
    n = model.ndof
    stiffness = _floats(model.stiffness, n, 0.0)
    springref = _floats(model.springref, n, 0.0)
    lo = _floats(model.limit_lo, n, -np.inf)
    hi = _floats(model.limit_hi, n, np.inf)
    ls = float(model.limit_stiffness)
    tau = []
    for j in range(n):
        t = -stiffness[j] * (q[j] - springref[j])
        if np.isfinite(hi[j]):
            t = t - ls * torch.clamp(q[j] - hi[j], min=0.0)
        if np.isfinite(lo[j]):
            t = t + ls * torch.clamp(lo[j] - q[j], min=0.0)
        tau.append(t)
    return tau


def _damping_rows(model: PlanarModel, q):
    """Implicit per-dof damping: joint damping plus limit damping while a
    limit is violated."""
    n = model.ndof
    damping = _floats(model.damping, n, 0.0)
    lo = _floats(model.limit_lo, n, -np.inf)
    hi = _floats(model.limit_hi, n, np.inf)
    ld = float(model.limit_damping)
    out = []
    for j in range(n):
        if np.isfinite(hi[j]) or np.isfinite(lo[j]):
            viol = (q[j] > hi[j]) | (q[j] < lo[j])
            out.append(damping[j] + torch.where(viol, ld, 0.0))
        else:
            out.append(damping[j] + torch.zeros_like(q[j]))
    return out


def _cholesky_rows(A_rows, n: int):
    """Cholesky on rows; A_rows[i][j] are [P] tensors (or floats off the
    diagonal). The pivot floor max(s, max(1e-5*A_ii, 1e-9)) is relative to
    the diagonal, as in the JAX engine."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A_rows[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                floor = torch.clamp(1e-5 * A_rows[i][i], min=1e-9)
                L[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_rows(L, b, n: int, Ldiag_inv=None):
    """Solve L L^T x = b, multiplying by precomputed inverse pivots."""
    if Ldiag_inv is None:
        Ldiag_inv = [1.0 / L[i][i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * Ldiag_inv[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * Ldiag_inv[i]
    return x


def step_rows(model: PlanarModel, q, qd, ctrl_rows, chains=None):
    """One control step on rows (no energy valve).

    q, qd: lists of ndof [P] tensors; ctrl_rows: list of n_act [P] tensors,
    already clipped. Returns (q_new, qd_new) row lists.
    """
    n = model.ndof
    chains = chains if chains is not None else _ancestors(model)
    dt_sub = model.dt / model.n_substeps

    # ---- once-per-control-step terms ---------------------------------------
    M_rows, bias_r = mass_bias_batched(model, q, qd, chains)
    # the 1e-6 diagonal regularizer is part of M (used in BOTH the lhs and
    # the M @ qd product)
    M_rows = [[(M_rows[i][j] + 1e-6) if i == j else M_rows[i][j]
               for j in range(n)] for i in range(n)]
    D = _damping_rows(model, q)
    A_rows = [[(M_rows[i][j] + dt_sub * D[i]) if i == j else M_rows[i][j]
               for j in range(n)] for i in range(n)]
    L = _cholesky_rows(A_rows, n)
    Ldiag_inv = [1.0 / L[i][i] for i in range(n)]

    # actuation (a dof may have several actuators: they add)
    gear = _floats(model.gear)
    tau_ctrl = [0.0] * n
    for a_i, dof in enumerate(model.actuator_dof):
        tau_ctrl[dof] = tau_ctrl[dof] + gear[a_i] * ctrl_rows[a_i]

    omega_max = float(model.motor_omega_max)
    finite_motor = np.isfinite(omega_max)
    has_drag = len(model.drag_normal) > 0
    max_qd = float(model.max_qd)

    for _ in range(model.n_substeps):
        tau_c = _contact_tau(model, q, qd, chains)
        tau_s = _spring_tau(model, q)
        tau_d = _drag_tau(model, q, qd, chains) if has_drag else None
        rhs = []
        for j in range(n):
            t = tau_ctrl[j]
            if finite_motor and not isinstance(t, float):
                speed = torch.clamp(1.0 - qd[j] * torch.sign(t) / omega_max, 0.0, 1.0)
                t = t * speed
            r = t + tau_s[j] + tau_c[j] - bias_r[j]
            if has_drag:
                r = r + tau_d[j]
            rhs.append(r)
        # b = M qd + dt * rhs
        b = []
        for i in range(n):
            s = dt_sub * rhs[i]
            for j in range(n):
                s = s + M_rows[i][j] * qd[j]
            b.append(s)
        qd_new = _chol_solve_rows(L, b, n, Ldiag_inv)
        qd = [torch.clamp(v, -max_qd, max_qd) for v in qd_new]
        q = [q[j] + dt_sub * qd[j] for j in range(n)]
    return q, qd



def rollout(model: PlanarModel, Q, QD, ACTS):
    """[P, ndof] Q, QD under clipped [P, h, n_act] ACTS -> (qs, qds) [h, P, ndof]."""
    chains = _ancestors(model)
    q, qd = list(Q.T), list(QD.T)
    qs, qds = [], []
    for t in range(ACTS.shape[1]):
        q, qd = step_rows(model, q, qd, list(ACTS[:, t].T), chains)
        qs.append(torch.stack(q, dim=1))
        qds.append(torch.stack(qd, dim=1))
    return torch.stack(qs), torch.stack(qds)


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
