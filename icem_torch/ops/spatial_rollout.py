"""Whole-horizon spatial (3D) rollout: the CUDA kernel and its plain version.

``rollout_spatial`` runs h control steps of ``n_substeps`` each for every
trajectory of a population, with the energy valve where the model turns it
on. On a CUDA tensor it launches the hand-written kernel of
``csrc/spatial_rollout.cu`` (one warp per trajectory); on a CPU tensor it
runs ``rollout_spatial_reference``, the row engine of
``envs/physics/spatial_batched.py`` looped over the horizon. There is no
fallback from one to the other.

Counterpart of ``icem_tpu/ops/spatial_rollout.py::rollout_spatial_pallas``,
with the same contract: Q, QD [P, ndof] and already-clipped ACTS
[P, h, n_act] in, (qs, qds) [h, P, ndof] out, float32. The TPU kernel's
block padding, horizon chunking and VMEM budget do not carry over: the
horizon is a loop inside the warp and any P is launched as it is.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from icem_torch.envs.physics import spatial_batched as sb
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.runtime import metrics


def kernel_shape(model: SpatialModel) -> tuple:
    """The template arguments <NDOF, NBODY, NGEOM, NACT> of the kernel."""
    return (model.ndof, model.nbody, len(model.geom_body), len(model.actuator_dof))


def _param_dtype(nd: int, nb: int, ng: int, na: int) -> np.dtype:
    """csrc/spatial_step.cuh::SpatialParams, field for field (all 4 bytes
    wide, so neither side pads). The first seven are tables of 16-byte rows:
    3-vectors padded to 4 floats, 3x3 tables to 3 rows of 4."""
    g, a = max(ng, 1), max(na, 1)
    i32, u32, f32 = np.int32, np.uint32, np.float32
    return np.dtype([
        ("anchor", f32, (nb, 4)), ("axis", f32, (nb, 4)), ("com", f32, (nb, 4)),
        ("inertia", f32, (nb, 4)), ("rod_k", f32, (nb, 12)), ("rod_k2", f32, (nb, 12)),
        ("geom_pos", f32, (g, 4)),
        ("parent", i32, (nb,)), ("depth", i32, (nb,)), ("chain_mask", u32, (nb,)),
        ("rod_k_mask", u32, (nb,)), ("rod_k2_mask", u32, (nb,)),
        ("geom_body", i32, (g,)), ("geom_chain_mask", u32, (g,)),
        ("actuator_dof", i32, (a,)), ("actuated_mask", u32),
        ("spring_mask", u32), ("hi_mask", u32), ("lo_mask", u32),
        ("finite_motor", i32), ("finite_fmax", i32), ("valve", i32),
        ("n_substeps", i32), ("max_depth", i32),
        ("mass", f32, (nb,)), ("grav_mass", f32, (nb,)),
        ("root_rot_offset", f32, (3, 3)),
        ("geom_radius", f32, (g,)), ("gear", f32, (a,)),
        ("damping", f32, (nd,)), ("stiffness", f32, (nd,)), ("springref", f32, (nd,)),
        ("limit_lo", f32, (nd,)), ("limit_hi", f32, (nd,)), ("max_qd", f32, (nd,)),
        ("trans_diag", f32), ("limit_stiffness", f32), ("limit_damping", f32),
        ("gravity", f32), ("contact_kp", f32), ("contact_kd", f32),
        ("contact_fmax", f32), ("pen_star", f32), ("friction_mu", f32),
        ("friction_kt", f32), ("motor_omega_max", f32), ("valve_eps", f32),
        ("dt_sub", f32),
    ])


def _bits(flags) -> int:
    return sum(1 << i for i, f in enumerate(flags) if f)


def _body_depths(parent) -> list:
    """Depth of every body in the tree (the root's is 0); a parent comes
    before its children."""
    depth = []
    for b, pa in enumerate(parent):
        if (pa < 0) != (b == 0) or pa >= b:
            raise ValueError(f"body {b} has parent {pa}: the root is body 0 and a "
                             f"parent precedes its children")
        depth.append(0 if pa < 0 else depth[pa] + 1)
    return depth


def pack_params(model: SpatialModel) -> np.ndarray:
    """The model as the kernel's parameter block (a one-element record).

    Constants that the plain version folds in float64 (the Rodrigues K @ K,
    gravity * mass, sum(mass) + 1e-6, fmax / kp, dt / n_substeps) are folded
    here in float64 and rounded to float32 once."""
    nd, nb, ng, na = kernel_shape(model)
    if max(nd, nb, ng, na) > 32:
        raise ValueError(f"the kernel's warp takes at most 32 dofs, bodies, geoms and "
                         f"actuators, got {nd}, {nb}, {ng}, {na}")
    rec = np.zeros(1, _param_dtype(nd, nb, ng, na))[0]
    # bit r: rotational dof r, which is dof r + 3 under a free root
    first_rot = 3 if model.free_root else 0
    chain_mask = [sum(1 << (j - first_rot) for j in chain) for chain in sb.rot_chains(model)]
    rec["parent"] = model.parent
    depth = _body_depths(model.parent)
    rec["depth"] = depth
    rec["max_depth"] = max(depth)
    rec["chain_mask"] = chain_mask
    axes = np.asarray(model.axis, np.float64)
    for b in range(nb):
        K, K2 = sb.rodrigues_tables(axes[b])
        rec["rod_k"][b].reshape(3, 4)[:, :3] = K
        rec["rod_k2"][b].reshape(3, 4)[:, :3] = K2
        rec["rod_k_mask"][b] = _bits(K.reshape(-1) != 0.0)
        rec["rod_k2_mask"][b] = _bits(K2.reshape(-1) != 0.0)
    if ng:
        rec["geom_body"] = model.geom_body
        rec["geom_chain_mask"] = [chain_mask[b] for b in model.geom_body]
        rec["geom_pos"][:, :3] = np.asarray(model.geom_pos).reshape(ng, 3)
        rec["geom_radius"] = model.geom_radius
    if na:
        rec["actuator_dof"] = model.actuator_dof
        rec["gear"] = model.gear
    rec["actuated_mask"] = _bits(j in set(model.actuator_dof) for j in range(nd))
    stiffness = sb._per_dof_np(model, model.stiffness, 0.0)
    lo = sb._per_dof_np(model, model.limit_lo, -np.inf)
    hi = sb._per_dof_np(model, model.limit_hi, np.inf)
    rec["spring_mask"] = _bits(stiffness != 0.0)
    rec["hi_mask"] = _bits(np.isfinite(hi))
    rec["lo_mask"] = _bits(np.isfinite(lo))
    rec["finite_motor"] = int(np.isfinite(model.motor_omega_max))
    rec["finite_fmax"] = int(np.isfinite(model.contact_fmax))
    rec["valve"] = int(bool(model.energy_valve))
    rec["n_substeps"] = model.n_substeps
    mass = np.asarray(model.mass, np.float64)
    for name in ("anchor", "axis", "com", "inertia"):
        rec[name][:, :3] = getattr(model, name)
    for name in ("mass", "root_rot_offset"):
        rec[name] = getattr(model, name)
    rec["grav_mass"] = float(model.gravity) * mass
    rec["stiffness"] = stiffness
    rec["damping"] = sb._per_dof_np(model, model.damping, 0.0)
    rec["springref"] = sb._per_dof_np(model, model.springref, 0.0)
    rec["limit_lo"] = lo
    rec["limit_hi"] = hi
    rec["max_qd"] = np.broadcast_to(np.asarray(model.max_qd, np.float64), (nd,))
    rec["trans_diag"] = float(mass.sum()) + 1e-6
    for name in ("limit_stiffness", "limit_damping", "gravity", "contact_kp",
                 "contact_kd", "contact_fmax", "friction_mu", "friction_kt",
                 "motor_omega_max"):
        rec[name] = float(getattr(model, name))
    fmax, kp = float(model.contact_fmax), float(model.contact_kp)
    rec["pen_star"] = fmax / kp if np.isfinite(fmax) else np.inf
    rec["valve_eps"] = float(model.energy_valve_eps)
    rec["dt_sub"] = model.dt / model.n_substeps
    return np.array(rec)


def _check_inputs(model: SpatialModel, Q, QD, ACTS):
    P, nd = Q.shape
    if nd != model.ndof or QD.shape != Q.shape:
        raise ValueError(f"Q, QD must be [P, {model.ndof}], got {tuple(Q.shape)}, "
                         f"{tuple(QD.shape)}")
    if ACTS.ndim != 3 or ACTS.shape[0] != P or ACTS.shape[2] != len(model.actuator_dof):
        raise ValueError(f"ACTS must be [{P}, h, {len(model.actuator_dof)}], "
                         f"got {tuple(ACTS.shape)}")
    for name, x in (("Q", Q), ("QD", QD), ("ACTS", ACTS)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != Q.device:
            raise ValueError(f"{name} is on {x.device}, Q on {Q.device}")


def rollout_spatial_reference(model: SpatialModel, Q, QD, ACTS):
    """The plain version: ``spatial_batched.step_rows`` looped over the
    horizon."""
    _check_inputs(model, Q, QD, ACTS)
    chains = sb.rot_chains(model)
    q, qd = list(Q.T), list(QD.T)
    qs, qds = [], []
    for t in range(ACTS.shape[1]):
        q, qd = sb.step_rows(model, q, qd, list(ACTS[:, t].T), chains)
        qs.append(torch.stack(q, dim=1))
        qds.append(torch.stack(qd, dim=1))
    return torch.stack(qs), torch.stack(qds)


# id(model) -> (model, BoundKernel). The entry holds the model, so its id
# cannot be reused by another model while it lives.
_LAUNCHERS: dict = {}


def _launcher(model: SpatialModel):
    """The model's BoundKernel, resolved and packed once per model, so that
    a launch only makes the ctypes call."""
    hit = _LAUNCHERS.get(id(model))
    if hit is not None and hit[0] is model:
        return hit[1]
    from icem_torch.ops._build import load_library

    kernel = bind(load_library()[0], model)
    _LAUNCHERS[id(model)] = (model, kernel)
    return kernel


@dataclass
class BoundKernel:
    """A C launcher and the parameter block of one model."""
    fn: object                       # the ctypes function of the model's shape
    params: np.ndarray               # the block on the host
    on_device: torch.Tensor | None = None  # its bytes on the card last launched on

    def params_on(self, device) -> torch.Tensor:
        """The block's bytes in ``device``'s memory, copied there once."""
        if self.on_device is None or self.on_device.device != device:
            raw = np.frombuffer(self.params.tobytes(), np.uint8).copy()
            self.on_device = torch.from_numpy(raw).to(device)
        return self.on_device


def bind(lib, model: SpatialModel) -> BoundKernel:
    """The C launcher of the model's shape in ``lib`` (a ctypes.CDLL of
    ``csrc/spatial_rollout.cu``) and the model's packed parameter block."""
    shape = "_".join(map(str, kernel_shape(model)))
    try:
        fn = getattr(lib, f"spatial_rollout_{shape}")
        nbytes = getattr(lib, f"spatial_params_bytes_{shape}")
    except AttributeError:
        raise ValueError(
            f"the spatial rollout kernel is not instantiated for the shape "
            f"<NDOF, NBODY, NGEOM, NACT> = <{shape.replace('_', ', ')}>; add it "
            f"to csrc/spatial_rollout.cu") from None
    fn.restype = ctypes.c_int
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ll, ptr, ll, ptr, ptr, ptr, ll, ctypes.c_int, ptr]
    nbytes.restype = ctypes.c_int
    params = pack_params(model)
    if params.nbytes != nbytes():
        raise RuntimeError(f"parameter block is {params.nbytes} bytes, the kernel "
                           f"expects {nbytes()}")
    return BoundKernel(fn, params)


def occupancy(lib, ptxas_log: str, model: SpatialModel) -> dict:
    """The kernel's resources at the model's shape, from a build of
    ``csrc/spatial_rollout.cu`` (``lib``, a ctypes.CDLL, and its ptxas log):
    registers, stack and spill bytes, dynamic shared memory per block and
    the warps an SM holds at once."""
    from icem_torch.ops import _build

    return _build.occupancy(lib, ptxas_log, "spatial", kernel_shape(model))


def launch_bound(kernel: BoundKernel, Q, QD, ACTS):
    """One launch of a kernel from ``bind`` on checked CUDA inputs; counts
    nothing. Returns (qs, qds) [h, P, nd]."""
    P, h = ACTS.shape[0], ACTS.shape[1]
    if P == 0 or h == 0:
        raise ValueError(f"empty rollout: P={P}, h={h}")
    # the kernel reads Q and QD where they are, rows at any stride (the env
    # passes column slices of its state), and writes [h, P, nd] directly
    q0, qd0 = (x if x.stride(1) == 1 else x.contiguous() for x in (Q, QD))
    acts = ACTS.contiguous()
    qs = torch.empty((h, P, Q.shape[1]), dtype=torch.float32, device=Q.device)
    qds = torch.empty_like(qs)
    params_dev = kernel.params_on(Q.device)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = kernel.fn(params_dev.data_ptr(), q0.data_ptr(), q0.stride(0), qd0.data_ptr(),
                        qd0.stride(0), acts.data_ptr(), qs.data_ptr(), qds.data_ptr(), P, h,
                        stream)
    if err != 0:
        raise RuntimeError(f"spatial rollout kernel launch failed: cudaError_t {err}")
    return qs, qds


def _launch(model: SpatialModel, Q, QD, ACTS):
    """One launch, counted as ``b2.launches`` and its rows as ``b2.rows``."""
    out = launch_bound(_launcher(model), Q, QD, ACTS)
    metrics.count("b2.launches")
    metrics.count("b2.rows", ACTS.shape[0])
    return out


def rollout_spatial(model: SpatialModel, Q, QD, ACTS):
    """Open-loop rollout. Q, QD: [P, ndof] float32; ACTS: [P, h, n_act]
    float32, already clipped. Returns (qs, qds): [h, P, ndof].

    CUDA tensors go through the kernel (and raise if it cannot run); CPU
    tensors through the plain version.
    """
    _check_inputs(model, Q, QD, ACTS)
    if Q.device.type == "cuda":
        return _launch(model, Q, QD, ACTS)
    if Q.device.type == "cpu":
        return rollout_spatial_reference(model, Q, QD, ACTS)
    raise ValueError(f"rollout_spatial runs on cuda or cpu, got {Q.device}")
