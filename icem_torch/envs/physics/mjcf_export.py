"""Export the physics models to MJCF for MuJoCo-oracle fidelity checks.

Counterpart of ``icem_tpu/envs/physics/mjcf_export.py``, numpy only, built on
the port's ``PlanarModel`` / ``SpatialModel``: the same model gives the same
document, character for character. The reference's forward model is MuJoCo
(icem/models/gt_model.py:59-102); the engines here are from-scratch
Lagrangian integrators. This module emits an MJCF document whose kinematic
tree, inertials, actuators, joint springs/dampers/limits and contact
geometry mirror a model exactly, so the ``mujoco`` package, where it is
installed, can serve as an oracle (``python -m icem_torch.tools.fidelity_oracle``,
whose ``main`` is the only place the port imports ``mujoco``).

Mapping notes (what is exact vs approximated):

- Kinematics are EXACT. MuJoCo composes stacked joints in declaration order
  like a chain of dummy bodies, so a free spatial root becomes 3 world
  slides + hinges about local z, y, x — with qpos ordered [yaw, pitch,
  roll], that is precisely our intrinsic chart R = Rz(yaw) Ry(pitch)
  Rx(roll) (verified numerically in tests). ``root_rot_offset`` becomes a
  nested body quat so the offset multiplies LEFT of the chart. Planar
  models embed as (x, z) slides + hinges about -y (our planar angle rotates
  x toward z).
- Inertials are EXACT: explicit ``<inertial>`` with the model's mass,
  body-frame COM and diagonal inertia (compiler inertiafromgeom=false).
- Joint springs/dampers are EXACT in form (MuJoCo applies
  -stiffness*(q-springref) - damping*qd as passive forces; its Euler
  integrator treats joint damping implicitly, like our semi-implicit
  update).
- Actuators: plain torque motors with the same gear. ``motor_omega_max``
  (our DC-motor speed-torque line) has no MJCF equivalent and is refused.
- Contacts/limits are STRUCTURALLY equivalent, not numerically identical:
  we emit explicit floor<->sphere pairs with solref="-kp -kd" (MuJoCo's
  direct spring-damper form) and solimp pinned near 1, but MuJoCo realizes
  them through its convex constraint solver (inverse-inertia-weighted,
  elliptic friction cone) while ours are raw penalty forces with clamped
  viscous friction. Joint limits likewise (constraint vs penalty). The
  fidelity harness therefore reports the smooth (contact-free) regime —
  where agreement must be tight — separately from the contact regime, where
  the drift curve IS the result.
- Integration: timestep = dt / n_substeps, integrator="Euler"
  (semi-implicit, like ours); our per-control-step frozen mass matrix and
  ``max_qd`` rail are deliberate deviations the harness quantifies.
"""

from __future__ import annotations

import numpy as np

from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.physics.spatial import SpatialModel

_SOLIMP = "0.9999 0.9999 0.0001 0.5 2"  # impedance pinned ~1: pure spring-damper


def _fmt(x) -> str:
    if isinstance(x, (list, tuple, np.ndarray)):
        return " ".join(_fmt(v) for v in np.asarray(x).ravel())
    return repr(float(x))


def _quat_from_mat(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix (robust branch)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _per_dof(model, arr, fill: float) -> np.ndarray:
    a = np.asarray(arr, np.float64)
    if a.shape[0] == 0:
        a = np.full(model.ndof, fill, np.float64)
    return a


def _joint_attrs(model, j: int, stiffness, springref, damping, lo, hi) -> str:
    attrs = []
    if damping[j] != 0.0:
        attrs.append(f'damping="{_fmt(damping[j])}"')
    if stiffness[j] != 0.0:
        attrs.append(f'stiffness="{_fmt(stiffness[j])}"'
                     f' springref="{_fmt(springref[j])}"')
    if np.isfinite(lo[j]) or np.isfinite(hi[j]):
        lo_j = lo[j] if np.isfinite(lo[j]) else -1e5
        hi_j = hi[j] if np.isfinite(hi[j]) else 1e5
        attrs.append(
            f'limited="true" range="{_fmt(lo_j)} {_fmt(hi_j)}" '
            f'solreflimit="{_fmt(-model.limit_stiffness)} '
            f'{_fmt(-model.limit_damping)}" solimplimit="{_SOLIMP}"')
    return (" " + " ".join(attrs)) if attrs else ""


def _children_of(parent) -> dict:
    kids: dict = {b: [] for b in range(len(parent))}
    for b in range(1, len(parent)):
        kids[parent[b]].append(b)
    return kids


def spatial_to_mjcf(model: SpatialModel, name: str = "spatial") -> str:
    """MJCF document equivalent to ``model`` (see module docstring).

    qpos layout differs from our q only in the root chart order:
    q = [x, y, z, roll, pitch, yaw, hinges...] maps to
    qpos = [x, y, z, yaw, pitch, roll, hinges...] (``qpos_from_q_spatial``).
    """
    if np.isfinite(model.motor_omega_max):
        raise ValueError("motor_omega_max has no MJCF equivalent")
    stiffness = _per_dof(model, model.stiffness, 0.0)
    springref = _per_dof(model, model.springref, 0.0)
    damping = _per_dof(model, model.damping, 0.0)
    lo = _per_dof(model, model.limit_lo, -np.inf)
    hi = _per_dof(model, model.limit_hi, np.inf)
    anchors = np.asarray(model.anchor, np.float64)
    axes = np.asarray(model.axis, np.float64)
    coms = np.asarray(model.com, np.float64)
    inertia = np.asarray(model.inertia, np.float64)
    kids = _children_of(model.parent)
    geoms_of: dict = {b: [] for b in range(model.nbody)}
    for g, b in enumerate(model.geom_body):
        geoms_of[b].append(g)
    gpos = np.asarray(model.geom_pos, np.float64)
    grad = np.asarray(model.geom_radius, np.float64)

    lines = []

    def geom_lines(b, ind):
        for g in geoms_of[b]:
            lines.append(
                f'{ind}<geom name="g{g}" type="sphere" '
                f'size="{_fmt(grad[g])}" pos="{_fmt(gpos[g])}" '
                f'contype="0" conaffinity="0"/>')

    def inertial_line(b, ind):
        lines.append(
            f'{ind}<inertial pos="{_fmt(coms[b])}" mass="{_fmt(model.mass[b])}"'
            f' diaginertia="{_fmt(inertia[b])}"/>')

    def body_rec(b, depth):
        ind = "  " * depth
        j = model.dof_of_body(b)
        lines.append(f'{ind}<body name="b{b}" pos="{_fmt(anchors[b])}">')
        lines.append(
            f'{ind}  <joint name="j{j}" type="hinge" axis="{_fmt(axes[b])}"'
            f'{_joint_attrs(model, j, stiffness, springref, damping, lo, hi)}/>')
        inertial_line(b, ind + "  ")
        geom_lines(b, ind + "  ")
        for c in kids[b]:
            body_rec(c, depth + 1)
        lines.append(f"{ind}</body>")

    if model.free_root:
        # One body holds all 6 root joints (stacked joints compose like a
        # chain of dummies, translations first). The body quat is the chart
        # offset Roff; joint axes are in the body's LOCAL frame, so world
        # slides need pre-rotated axes Roff^T e_k, while the chart hinges
        # use local z, y, x so the world rotation composes as
        # Roff Rz(yaw) Ry(pitch) Rx(roll) = spatial._rot_rpy's chart.
        Roff = np.asarray(model.root_rot_offset, np.float64)
        quat = _quat_from_mat(Roff)
        lines.append(f'    <body name="b0" pos="{_fmt(anchors[0])}"'
                     f' quat="{_fmt(quat)}">')
        for k in range(3):
            lines.append(
                f'      <joint name="j{k}" type="slide" axis="{_fmt(Roff.T[:, k])}"'
                f'{_joint_attrs(model, k, stiffness, springref, damping, lo, hi)}/>')
        for jname, ax in ((5, "0 0 1"), (4, "0 1 0"), (3, "1 0 0")):
            lines.append(
                f'      <joint name="j{jname}" type="hinge" axis="{ax}"'
                f'{_joint_attrs(model, jname, stiffness, springref, damping, lo, hi)}/>')
        inertial_line(0, "      ")
        geom_lines(0, "      ")
        for c in kids[0]:
            body_rec(c, 4)
        lines.append("    </body>")
    else:
        lines.append(f'    <body name="b0" pos="{_fmt(anchors[0])}">')
        lines.append(
            f'      <joint name="j0" type="hinge" axis="{_fmt(axes[0])}"'
            f'{_joint_attrs(model, 0, stiffness, springref, damping, lo, hi)}/>')
        inertial_line(0, "      ")
        geom_lines(0, "      ")
        for c in kids[0]:
            body_rec(c, 4)
        lines.append("    </body>")

    return _document(model, name, lines, n_geoms=len(model.geom_body),
                     actuator_dof=model.actuator_dof,
                     gear=np.asarray(model.gear, np.float64))


def planar_to_mjcf(model: PlanarModel, name: str = "planar") -> str:
    """MJCF document equivalent to a ``PlanarModel``.

    Embedding: planar (x, z) -> world (x, 0, z); planar angles rotate x
    toward z, i.e. hinge about world -y. qpos == q (``qpos_from_q_planar``
    is the identity).
    """
    if np.isfinite(model.motor_omega_max):
        raise ValueError("motor_omega_max has no MJCF equivalent")
    if np.asarray(model.drag_normal, np.float64).size:
        raise ValueError("viscous body drag has no MJCF equivalent")
    stiffness = _per_dof(model, model.stiffness, 0.0)
    springref = _per_dof(model, model.springref, 0.0)
    damping = _per_dof(model, model.damping, 0.0)
    lo = _per_dof(model, model.limit_lo, -np.inf)
    hi = _per_dof(model, model.limit_hi, np.inf)

    def lift(p2):  # planar (x, z) -> 3D
        return np.array([p2[0], 0.0, p2[1]])

    anchors = np.asarray(model.anchor, np.float64)
    coms2 = np.asarray(model.com, np.float64)
    inertia = np.asarray(model.inertia, np.float64)
    kids = _children_of(model.parent)
    geoms_of: dict = {b: [] for b in range(model.nbody)}
    for g, b in enumerate(model.geom_body):
        geoms_of[b].append(g)
    gpos = np.asarray(model.geom_pos, np.float64)
    grad = np.asarray(model.geom_radius, np.float64)

    lines = []

    def body_lines(b, ind):
        # a planar body's inertia is the scalar about the hinge (y) axis;
        # out-of-plane inertia never enters planar dynamics — set the x/z
        # diagonal to the same value (any positive value is dynamically
        # inert for y-hinge trees, this one keeps MuJoCo's checks happy)
        iy = max(float(inertia[b]), 1e-9)
        lines.append(
            f'{ind}<inertial pos="{_fmt(lift(coms2[b]))}" '
            f'mass="{_fmt(model.mass[b])}" diaginertia="{iy!r} {iy!r} {iy!r}"/>')
        for g in geoms_of[b]:
            lines.append(
                f'{ind}<geom name="g{g}" type="sphere" size="{_fmt(grad[g])}"'
                f' pos="{_fmt(lift(gpos[g]))}" contype="0" conaffinity="0"/>')

    def body_rec(b, depth):
        ind = "  " * depth
        j = model.dof_of_body(b)
        lines.append(f'{ind}<body name="b{b}" pos="{_fmt(lift(anchors[b]))}">')
        lines.append(
            f'{ind}  <joint name="j{j}" type="hinge" axis="0 -1 0"'
            f'{_joint_attrs(model, j, stiffness, springref, damping, lo, hi)}/>')
        body_lines(b, ind + "  ")
        for c in kids[b]:
            body_rec(c, depth + 1)
        lines.append(f"{ind}</body>")

    if model.free_root:
        lines.append(f'    <body name="b0" pos="{_fmt(lift(anchors[0]))}">')
        for k, ax in ((0, "1 0 0"), (1, "0 0 1")):
            lines.append(f'      <joint name="j{k}" type="slide" axis="{ax}"'
                         f'{_joint_attrs(model, k, stiffness, springref, damping, lo, hi)}/>')
        lines.append(f'      <joint name="j2" type="hinge" axis="0 -1 0"'
                     f'{_joint_attrs(model, 2, stiffness, springref, damping, lo, hi)}/>')
        body_lines(0, "      ")
        for c in kids[0]:
            body_rec(c, 4)
        lines.append("    </body>")
    else:
        lines.append(f'    <body name="b0" pos="{_fmt(lift(anchors[0]))}">')
        lines.append(f'      <joint name="j0" type="hinge" axis="0 -1 0"'
                     f'{_joint_attrs(model, 0, stiffness, springref, damping, lo, hi)}/>')
        body_lines(0, "      ")
        for c in kids[0]:
            body_rec(c, 4)
        lines.append("    </body>")

    return _document(model, name, lines, n_geoms=len(model.geom_body),
                     actuator_dof=model.actuator_dof,
                     gear=np.asarray(model.gear, np.float64))


def _document(model, name, body_lines, *, n_geoms, actuator_dof, gear) -> str:
    head = [
        f'<mujoco model="{name}">',
        f'  <compiler angle="radian" inertiafromgeom="false" autolimits="false"/>',
        f'  <option timestep="{_fmt(model.dt / model.n_substeps)}"'
        f' gravity="0 0 {_fmt(-model.gravity)}" integrator="Euler"/>',
        "  <worldbody>",
        '    <geom name="floor" type="plane" size="50 50 1" pos="0 0 0"'
        ' contype="0" conaffinity="0"/>',
    ]
    tail = ["  </worldbody>"]
    if n_geoms:
        tail.append("  <contact>")
        for g in range(n_geoms):
            # friction: [tangent1 tangent2 torsion roll1 roll2]; our engine
            # has no torsional/rolling friction
            tail.append(
                f'    <pair geom1="floor" geom2="g{g}" condim="3" '
                f'solref="{_fmt(-model.contact_kp)} {_fmt(-model.contact_kd)}" '
                f'solimp="{_SOLIMP}" '
                f'friction="{_fmt(model.friction_mu)} {_fmt(model.friction_mu)}'
                f' 0.0001 0.0001 0.0001"/>')
        tail.append("  </contact>")
    if len(actuator_dof):
        tail.append("  <actuator>")
        for a, dof in enumerate(actuator_dof):
            tail.append(f'    <motor joint="j{dof}" gear="{_fmt(gear[a])}"'
                        f' ctrlrange="-1 1" ctrllimited="true"/>')
        tail.append("  </actuator>")
    tail.append("</mujoco>")
    return "\n".join(head + body_lines + tail) + "\n"


# ---------------------------------------------------------------------------
# state layout adapters
# ---------------------------------------------------------------------------


def qpos_from_q_spatial(q: np.ndarray, free_root: bool) -> np.ndarray:
    """Our q [.., roll, pitch, yaw, ..] -> MJCF qpos [.., yaw, pitch, roll, ..]
    (joints are declared z, y, x so the stacked-hinge chart composes as
    Rz(yaw) Ry(pitch) Rx(roll), matching spatial._rot_rpy)."""
    q = np.asarray(q, np.float64).copy()
    if free_root:
        q[..., [3, 5]] = q[..., [5, 3]]
    return q


def q_from_qpos_spatial(qpos: np.ndarray, free_root: bool) -> np.ndarray:
    return qpos_from_q_spatial(qpos, free_root)  # the swap is an involution


def qvel_from_qd_spatial(qd: np.ndarray, free_root: bool) -> np.ndarray:
    """Chart RATES reorder exactly like the coordinates: MuJoCo hinge qvel
    is the time derivative of its qpos for stacked hinges."""
    return qpos_from_q_spatial(qd, free_root)
