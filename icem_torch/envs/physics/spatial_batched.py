"""Population-batched spatial (3D) physics on flat ``[P]`` rows: the plain
version of the spatial rollout kernel.

Counterpart of ``icem_tpu/envs/physics/spatial_batched.py``. Every physical
scalar (a coordinate, a rotation-matrix entry, a force component) is one
``[P]`` tensor with the population along it, or a Python float where the
value does not depend on the state. ``step_rows`` is one control step and is
what ``csrc/spatial_step.cuh`` computes for one trajectory; the wrapper in
``ops/spatial_rollout.py`` runs it on CPU tensors and holds the kernel
against it on the card.

Everything is closed-form. Every rotational dof j (a hinge, or one of the
root's roll/pitch/yaw chart rates) has a world axis w_j and a pivot o_j, so
the point-Jacobian column of a world point p is w_j x (p - o_j). From these:

- mass matrix  M_ij = sum_b m_b <Jv_i, Jv_j> + u_i . (I_b * u_j) with
  u_i = R_b^T w_i (the inertia stays diagonal in the body frame),
- bias (Coriolis/centrifugal + gravity) from one recursive pass of
  velocity-product accelerations,
- contacts per substep from the same columns (isotropic Coulomb clamp),
- the energy valve from closed-form kinetic and stored energy.

Division of labour per control step: mass matrix, implicit-damping Cholesky
factor and bias once; contacts, springs and limits per substep; the valve at
the end. Model constants enter as Python floats (float64), folded in float64
where the JAX engine folds them, and rounded to float32 where they meet a
tensor. Every switch on the state is a ``torch.where`` or a clamp, never a
Python branch on data; Python branches read only the static model.
"""

from __future__ import annotations

import numpy as np
import torch

from icem_torch.envs.physics.batched import _chol_solve_rows, _cholesky_rows
from icem_torch.envs.physics.spatial import SpatialModel

# ---------------------------------------------------------------------------
# component-expanded 3-vector / 3x3-matrix algebra on rows
# ---------------------------------------------------------------------------


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _matvec(R, v):
    return tuple(R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2]
                 for i in range(3))


def _matTvec(R, v):
    return tuple(R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2]
                 for i in range(3))


def _matmul(A, B):
    return tuple(tuple(A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
                       for j in range(3)) for i in range(3))


def rodrigues_tables(axis):
    """(K, K @ K) of a fixed unit axis, in float64: the skew matrix and its
    square, as the kernel's parameter block packs them."""
    a = np.asarray(axis, np.float64)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return K, K @ K


def _rodrigues(axis_np, theta):
    """R = I + sin K + (1-cos) K^2 with K the constant skew of a fixed axis.
    Entries whose K / K^2 coefficients are exactly zero stay constants."""
    K, K2 = rodrigues_tables(axis_np)
    s, c = torch.sin(theta), torch.cos(theta)
    one_m_c = 1.0 - c
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            e = float(i == j)
            if K[i, j] != 0.0:
                e = e + s * float(K[i, j])
            if K2[i, j] != 0.0:
                e = e + one_m_c * float(K2[i, j])
            row.append(e)
        rows.append(tuple(row))
    return tuple(rows)


# ---------------------------------------------------------------------------
# static tree structure
# ---------------------------------------------------------------------------


def rot_chains(model: SpatialModel):
    """Per body: ascending list of rotational dof indices on its root chain
    (the root contributes [3, 4, 5] rpy dofs when free, [0] when hinged)."""
    out = []
    for b in range(model.nbody):
        bodies, c = [], b
        while c != -1:
            bodies.append(c)
            c = model.parent[c]
        bodies.reverse()
        dofs = []
        for c in bodies:
            if c == 0:
                dofs += [3, 4, 5] if model.free_root else [0]
            else:
                dofs.append(model.dof_of_body(c))
        out.append(dofs)
    return out


def _per_dof_np(model: SpatialModel, arr, fill: float):
    """A per-dof model array in float64; zero-length (the default) -> fill."""
    a = np.asarray(arr, np.float64)
    if a.shape[0] == 0:
        a = np.full(model.ndof, fill, np.float64)
    return a


def _vec(x):
    return tuple(float(v) for v in x)


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def fk_rows(model: SpatialModel, q):
    """q: list of ndof rows.

    Returns (origins, rots, axes, coms, geom_pts):
    - origins[b]: joint-origin 3-tuple, rots[b]: 3x3 nested tuple,
    - axes[j]: (world axis 3-tuple, pivot 3-tuple) for rotational dof j,
      None for root translations,
    - coms[b], geom_pts[g]: world 3-tuples.
    """
    B = model.nbody
    anchors = np.asarray(model.anchor, np.float64)
    axes_np = np.asarray(model.axis, np.float64)
    com_l = np.asarray(model.com, np.float64)
    axes = [None] * model.ndof
    origins, rots = [], []

    if model.free_root:
        Roff = np.asarray(model.root_rot_offset, np.float64).tolist()
        cr, sr = torch.cos(q[3]), torch.sin(q[3])
        cp, sp = torch.cos(q[4]), torch.sin(q[4])
        cy, sy = torch.cos(q[5]), torch.sin(q[5])
        # R_rpy = Rz(yaw) Ry(pitch) Rx(roll), expanded
        Rr = ((cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr),
              (sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr),
              (-sp, cp * sr, cp * cr))
        R0 = tuple(tuple(Roff[i][0] * Rr[0][j] + Roff[i][1] * Rr[1][j]
                         + Roff[i][2] * Rr[2][j] for j in range(3))
                   for i in range(3))
        a0 = _vec(anchors[0])
        o0 = (q[0] + a0[0], q[1] + a0[1], q[2] + a0[2])
        # instantaneous world axes of the rpy chart (pivot: root origin)
        w_y = (Roff[0][2], Roff[1][2], Roff[2][2])
        w_p = tuple(Roff[i][0] * (-sy) + Roff[i][1] * cy for i in range(3))
        w_r = tuple(Roff[i][0] * (cy * cp) + Roff[i][1] * (sy * cp)
                    + Roff[i][2] * (-sp) for i in range(3))
        axes[3], axes[4], axes[5] = (w_r, o0), (w_p, o0), (w_y, o0)
    else:
        R0 = _rodrigues(axes_np[0], q[0])
        o0 = _vec(anchors[0])
        axes[0] = (_vec(axes_np[0]), o0)
    origins.append(o0)
    rots.append(R0)

    for b in range(1, B):
        pa = model.parent[b]
        j = model.dof_of_body(b)
        Rp, op = rots[pa], origins[pa]
        Rb = _matmul(Rp, _rodrigues(axes_np[b], q[j]))
        ob = _add(op, _matvec(Rp, _vec(anchors[b])))
        axes[j] = (_matvec(Rp, _vec(axes_np[b])), ob)
        origins.append(ob)
        rots.append(Rb)

    coms = [_add(origins[b], _matvec(rots[b], _vec(com_l[b]))) for b in range(B)]
    gpos = np.asarray(model.geom_pos, np.float64)
    geom_pts = [_add(origins[b], _matvec(rots[b], _vec(gpos[g])))
                for g, b in enumerate(model.geom_body)]
    return origins, rots, axes, coms, geom_pts


# ---------------------------------------------------------------------------
# mass matrix + bias (Coriolis/centrifugal + gravity)
# ---------------------------------------------------------------------------


def mass_bias_rows(model: SpatialModel, q, qd, fkres=None, chains=None):
    """Closed-form mass matrix and bias. Returns (M nested lists [i][j],
    symmetric, and the bias list); entries no body touches stay 0.0."""
    n = model.ndof
    origins, rots, axes, coms, _ = fkres if fkres is not None else fk_rows(model, q)
    chains = chains if chains is not None else rot_chains(model)
    mass = np.asarray(model.mass, np.float64)
    inertia = np.asarray(model.inertia, np.float64)
    free = bool(model.free_root)
    g = float(model.gravity)
    B = model.nbody

    # ---- recursive velocity-product pass (qdd = 0). The JAX engine also
    # carries the joint-origin velocities, which nothing reads; they are
    # left out here. -----------------------------------------------------------
    omega, alpha, a_o = [None] * B, [None] * B, [None] * B
    if free:
        (w_r, _), (w_p, _), (w_y, _) = axes[3], axes[4], axes[5]
        omega[0] = tuple(qd[3] * w_r[k] + qd[4] * w_p[k] + qd[5] * w_y[k]
                         for k in range(3))
        wy_x_wr, wp_x_wr = _cross(w_y, w_r), _cross(w_p, w_r)
        wy_x_wp = _cross(w_y, w_p)
        alpha[0] = tuple(qd[3] * (qd[5] * wy_x_wr[k] + qd[4] * wp_x_wr[k])
                         + qd[4] * qd[5] * wy_x_wp[k] for k in range(3))
    else:
        omega[0] = _scale(qd[0], axes[0][0])
        alpha[0] = (0.0, 0.0, 0.0)
    a_o[0] = (0.0, 0.0, 0.0)

    for b in range(1, B):
        pa = model.parent[b]
        j = model.dof_of_body(b)
        w = axes[j][0]
        r = _sub(origins[b], origins[pa])
        a_o[b] = _add(a_o[pa], _add(_cross(alpha[pa], r),
                                    _cross(omega[pa], _cross(omega[pa], r))))
        omega[b] = _add(omega[pa], _scale(qd[j], w))
        alpha[b] = _add(alpha[pa], _scale(qd[j], _cross(omega[pa], w)))

    # ---- assemble M (lower triangle) and bias -------------------------------
    bias = [0.0] * n
    M = [[0.0] * n for _ in range(n)]
    if free:
        total_m = float(mass.sum())
        for t in range(3):
            M[t][t] = total_m

    for b in range(B):
        m_b = float(mass[b])
        I_b = _vec(inertia[b])
        r = _sub(coms[b], origins[b])
        a_c = _add(a_o[b], _add(_cross(alpha[b], r),
                                _cross(omega[b], _cross(omega[b], r))))
        f_iner = (m_b * a_c[0], m_b * a_c[1], m_b * (a_c[2] + g))
        # rotational torque term: R (I * R^T alpha) + omega x (R (I * R^T omega))
        u_al = _matTvec(rots[b], alpha[b])
        u_om = _matTvec(rots[b], omega[b])
        Ia = tuple(I_b[k] * u_al[k] for k in range(3))
        Io = tuple(I_b[k] * u_om[k] for k in range(3))
        tau_rot = _add(_matvec(rots[b], Ia),
                       _cross(omega[b], _matvec(rots[b], Io)))
        if free:
            bias[0] = bias[0] + f_iner[0]
            bias[1] = bias[1] + f_iner[1]
            bias[2] = bias[2] + f_iner[2]

        cols = []
        for j in chains[b]:
            w, piv = axes[j]
            Jv = _cross(w, _sub(coms[b], piv))
            cols.append((j, w, Jv))
            bias[j] = bias[j] + _dot(Jv, f_iner) + _dot(w, tau_rot)

        us = [_matTvec(rots[b], w) for (_, w, _) in cols]
        for ii in range(len(cols)):
            ji, _, Jvi = cols[ii]
            for jj in range(ii + 1):
                jjj, _, Jvj = cols[jj]
                lo, hi = (jjj, ji) if ji >= jjj else (ji, jjj)
                val = m_b * _dot(Jvi, Jvj) + sum(
                    I_b[k] * us[ii][k] * us[jj][k] for k in range(3))
                M[hi][lo] = M[hi][lo] + val
        if free:
            for (j, _, Jv) in cols:
                for t in range(3):
                    M[j][t] = M[j][t] + m_b * Jv[t]

    for i in range(n):
        for j in range(i):
            M[j][i] = M[i][j]
    return M, bias


# ---------------------------------------------------------------------------
# energies (for the energy-consistency valve)
# ---------------------------------------------------------------------------


def kinetic_rows(model: SpatialModel, qd, fkres, chains):
    """T(q, qd) from Jacobian columns: one velocity pass."""
    _, rots, axes, coms, _ = fkres
    mass = np.asarray(model.mass, np.float64)
    inertia = np.asarray(model.inertia, np.float64)
    free = bool(model.free_root)
    ke = 0.0
    for b in range(model.nbody):
        I_b = _vec(inertia[b])
        v = [qd[0], qd[1], qd[2]] if free else [0.0, 0.0, 0.0]
        om = [0.0, 0.0, 0.0]
        for j in chains[b]:
            w, piv = axes[j]
            Jv = _cross(w, _sub(coms[b], piv))
            for k in range(3):
                v[k] = v[k] + qd[j] * Jv[k]
                om[k] = om[k] + qd[j] * w[k]
        u = _matTvec(rots[b], om)
        ke = ke + 0.5 * float(mass[b]) * _dot(v, v)
        ke = ke + 0.5 * sum(I_b[k] * u[k] * u[k] for k in range(3))
    return ke


def stored_energy_rows(model: SpatialModel, q, qd, fkres, chains, ke=None):
    """Kinetic + gravity PE + joint/limit spring PE + (fmax-capped) contact
    spring PE. ``ke``, where the caller has it, is ``kinetic_rows`` of the
    same state."""
    _, _, _, coms, geom_pts = fkres
    mass = np.asarray(model.mass, np.float64)
    e = kinetic_rows(model, qd, fkres, chains) if ke is None else ke
    for b in range(model.nbody):
        e = e + float(model.gravity) * float(mass[b]) * coms[b][2]

    stiffness = _per_dof_np(model, model.stiffness, 0.0)
    springref = _per_dof_np(model, model.springref, 0.0)
    lo = _per_dof_np(model, model.limit_lo, -np.inf)
    hi = _per_dof_np(model, model.limit_hi, np.inf)
    ls = float(model.limit_stiffness)
    for j in range(model.ndof):
        if stiffness[j] != 0.0:
            e = e + 0.5 * float(stiffness[j]) * (q[j] - float(springref[j])) ** 2
        if np.isfinite(hi[j]):
            e = e + 0.5 * ls * torch.clamp(q[j] - float(hi[j]), min=0.0) ** 2
        if np.isfinite(lo[j]):
            e = e + 0.5 * ls * torch.clamp(float(lo[j]) - q[j], min=0.0) ** 2

    radius = np.asarray(model.geom_radius, np.float64)
    kp, fmax = float(model.contact_kp), float(model.contact_fmax)
    fmax_finite = np.isfinite(fmax)
    pen_star = (fmax / kp) if fmax_finite else np.inf
    for g_i in range(len(model.geom_body)):
        pen = torch.clamp(float(radius[g_i]) - geom_pts[g_i][2], min=0.0)
        if fmax_finite:
            e = e + 0.5 * kp * torch.clamp(pen, max=pen_star) ** 2
            e = e + fmax * torch.clamp(pen - pen_star, min=0.0)
        else:
            e = e + 0.5 * kp * pen**2
    return e


# ---------------------------------------------------------------------------
# per-substep forces
# ---------------------------------------------------------------------------


def contact_tau_rows(model: SpatialModel, qd, fkres, chains):
    """Generalized ground-contact forces assembled from Jacobian columns
    w_j x (p - o_j): normal spring-damper along z (capped at fmax), viscous
    tangential friction with its 2-norm clamped to mu * fn."""
    _, _, axes, _, geom_pts = fkres
    n = model.ndof
    free = bool(model.free_root)
    radius = np.asarray(model.geom_radius, np.float64)
    kp, kd = float(model.contact_kp), float(model.contact_kd)
    fmax, mu, kt = (float(model.contact_fmax), float(model.friction_mu),
                    float(model.friction_kt))
    tau = [0.0] * n
    for g_i, b in enumerate(model.geom_body):
        p = geom_pts[g_i]
        v = [qd[0], qd[1], qd[2]] if free else [0.0, 0.0, 0.0]
        cols = []
        for j in chains[b]:
            w, piv = axes[j]
            Jc = _cross(w, _sub(p, piv))
            cols.append((j, Jc))
            for k in range(3):
                v[k] = v[k] + qd[j] * Jc[k]
        phi = p[2] - float(radius[g_i])
        fn = torch.clamp(-kp * phi - kd * v[2], min=0.0)
        if np.isfinite(fmax):
            fn = torch.clamp(fn, max=fmax)
        fn = torch.where(phi < 0.0, fn, 0.0)
        ftx = -kt * v[0]
        fty = -kt * v[1]
        ft_norm = torch.sqrt(ftx * ftx + fty * fty)
        scale = torch.clamp(mu * fn / torch.clamp(ft_norm, min=1e-9), max=1.0)
        f = (ftx * scale, fty * scale, fn)
        if free:
            tau[0] = tau[0] + f[0]
            tau[1] = tau[1] + f[1]
            tau[2] = tau[2] + f[2]
        for j, Jc in cols:
            tau[j] = tau[j] + _dot(Jc, f)
    return tau


def spring_tau_rows(model: SpatialModel, q):
    """Joint springs + limit penalties; a dof without either stays 0.0."""
    stiffness = _per_dof_np(model, model.stiffness, 0.0)
    springref = _per_dof_np(model, model.springref, 0.0)
    lo = _per_dof_np(model, model.limit_lo, -np.inf)
    hi = _per_dof_np(model, model.limit_hi, np.inf)
    ls = float(model.limit_stiffness)
    tau = []
    for j in range(model.ndof):
        t = 0.0
        if stiffness[j] != 0.0:
            t = float(-stiffness[j]) * (q[j] - float(springref[j]))
        if np.isfinite(hi[j]):
            t = t - ls * torch.clamp(q[j] - float(hi[j]), min=0.0)
        if np.isfinite(lo[j]):
            t = t + ls * torch.clamp(float(lo[j]) - q[j], min=0.0)
        tau.append(t)
    return tau


def damping_rows(model: SpatialModel, q):
    """Implicit per-dof damping: joint damping plus limit damping while a
    limit is violated."""
    damping = _per_dof_np(model, model.damping, 0.0)
    lo = _per_dof_np(model, model.limit_lo, -np.inf)
    hi = _per_dof_np(model, model.limit_hi, np.inf)
    ld = float(model.limit_damping)
    out = []
    for j in range(model.ndof):
        d = float(damping[j])
        if np.isfinite(hi[j]) or np.isfinite(lo[j]):
            viol = (q[j] > float(hi[j])) | (q[j] < float(lo[j]))
            d = d + torch.where(viol, ld, 0.0)
        else:
            d = d + torch.zeros_like(q[j])
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# control step
# ---------------------------------------------------------------------------


def step_rows(model: SpatialModel, q, qd, ctrl_rows, chains=None):
    """One control step on rows, with the energy valve where the model turns
    it on.

    q, qd: lists of ndof [P] tensors; ctrl_rows: list of n_act [P] tensors,
    already clipped. Returns (q_new, qd_new) row lists.
    """
    n = model.ndof
    chains = chains if chains is not None else rot_chains(model)
    dt_sub = model.dt / model.n_substeps

    # ---- once-per-control-step terms ---------------------------------------
    fk0 = fk_rows(model, q)
    M, bias_r = mass_bias_rows(model, q, qd, fk0, chains)
    # the 1e-6 diagonal regularizer is part of M (used in BOTH the lhs and
    # the M @ qd product)
    M = [[(M[i][j] + 1e-6) if i == j else M[i][j] for j in range(n)]
         for i in range(n)]
    D = damping_rows(model, q)
    A = [[(M[i][j] + dt_sub * D[i]) if i == j else M[i][j] for j in range(n)]
         for i in range(n)]
    L = _cholesky_rows(A, n)
    Ldiag_inv = [1.0 / L[i][i] for i in range(n)]

    gear = np.asarray(model.gear, np.float64).tolist()
    tau_ctrl = [0.0] * n
    for a_i, dof in enumerate(model.actuator_dof):
        tau_ctrl[dof] = tau_ctrl[dof] + gear[a_i] * ctrl_rows[a_i]

    omega_max = float(model.motor_omega_max)
    finite_motor = np.isfinite(omega_max)
    max_qd = np.broadcast_to(np.asarray(model.max_qd, np.float64), (n,)).tolist()
    valve = bool(model.energy_valve)

    work = torch.zeros_like(q[0])
    q_, qd_ = q, qd
    for _ in range(model.n_substeps):
        fk = fk_rows(model, q_)
        tau_c = contact_tau_rows(model, qd_, fk, chains)
        tau_s = spring_tau_rows(model, q_)
        taus, rhs = [], []
        for j in range(n):
            t = tau_ctrl[j]
            if finite_motor and not isinstance(t, float):
                speed = torch.clamp(1.0 - qd_[j] * torch.sign(t) / omega_max, 0.0, 1.0)
                t = t * speed
            taus.append(t)
            rhs.append(t + tau_s[j] + tau_c[j] - bias_r[j])
        b = []
        for i in range(n):
            s = dt_sub * rhs[i]
            for j in range(n):
                s = s + M[i][j] * qd_[j]
            b.append(s)
        qd_new = _chol_solve_rows(L, b, n, Ldiag_inv)
        qd_new = [torch.clamp(v, -max_qd[j], max_qd[j]) for j, v in enumerate(qd_new)]
        q_new = [q_[j] + dt_sub * qd_new[j] for j in range(n)]
        if valve:
            dw = 0.0
            for j in range(n):
                if not isinstance(taus[j], float):
                    dw = dw + taus[j] * qd_new[j]
            work = work + dt_sub * dw
        q_, qd_ = q_new, qd_new

    if valve:
        e0 = stored_energy_rows(model, q, qd, fk0, chains)
        bound = e0 + torch.clamp(work, min=0.0) + float(model.energy_valve_eps)
        fk1 = fk_rows(model, q_)
        ke1 = kinetic_rows(model, qd_, fk1, chains)
        e1 = stored_energy_rows(model, q_, qd_, fk1, chains, ke=ke1)
        excess = e1 - bound
        scale2 = torch.clamp((ke1 - excess) / torch.clamp(ke1, min=1e-9), 0.0, 1.0)
        sf = torch.sqrt(scale2)
        qd_ = [v * sf for v in qd_]
    return q_, qd_


def step_batched(model: SpatialModel, Q, QD, CTRL):
    """One control step of a population: Q, QD [P, ndof], CTRL [P, n_act]
    (already clipped) -> (Q, QD) [P, ndof]. Any P."""
    q, qd = step_rows(model, list(Q.T), list(QD.T), list(CTRL.T))
    return torch.stack(q, dim=1), torch.stack(qd, dim=1)
