"""Whole-horizon planar-physics rollout: the CUDA kernel and its plain version.

``rollout_planar`` runs h control steps of ``n_substeps`` each for every
trajectory of a population. On a CUDA tensor it launches the hand-written
kernel of ``csrc/planar_rollout.cu`` (a group of lanes per trajectory over a
shared-memory workspace), in one of its two instantiations: the throughput
one (2 lanes a trajectory) where the population fills the card, the latency
one (a lane per item) below that (``takes_latency``); on a CPU tensor it runs
``rollout_planar_reference``, the row engine of ``envs/physics/batched.py``
looped over the horizon. There is no fallback from one to the other.

Counterpart of ``icem_tpu/ops/planar_rollout.py::rollout_planar_pallas``,
with the same contract: Q, QD [P, ndof] and already-clipped ACTS
[P, h, n_act] in, (qs, qds) [h, P, ndof] out. No energy valve: the
imagination path is valveless by design.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from icem_torch.envs.physics import batched
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.runtime import metrics


def kernel_shape(model: PlanarModel) -> tuple:
    """The template arguments <NDOF, NBODY, NGEOM, NACT> of the kernel."""
    return (model.ndof, model.nbody, len(model.geom_body), len(model.actuator_dof))


def _param_dtype(nd: int, nb: int, ng: int, na: int) -> np.dtype:
    """csrc/planar_step.cuh::PlanarParams, field for field (all 4 bytes wide,
    so neither side pads)."""
    g, a = max(ng, 1), max(na, 1)
    i32, f32 = np.int32, np.float32
    return np.dtype([
        ("parent", i32, (nb,)), ("anc_mask", i32, (nb,)),
        ("geom_body", i32, (g,)), ("geom_anc_mask", i32, (g,)),
        ("actuator_dof", i32, (a,)), ("actuated_mask", i32),
        ("has_drag", i32), ("finite_motor", i32), ("n_substeps", i32),
        ("anchor", f32, (nb, 2)), ("com", f32, (nb, 2)),
        ("mass", f32, (nb,)), ("inertia", f32, (nb,)),
        ("geom_pos", f32, (g, 2)), ("geom_radius", f32, (g,)),
        ("gear", f32, (a,)),
        ("damping", f32, (nd,)), ("stiffness", f32, (nd,)),
        ("springref", f32, (nd,)), ("limit_lo", f32, (nd,)),
        ("limit_hi", f32, (nd,)),
        ("drag_normal", f32, (nb,)), ("drag_tangent", f32, (nb,)),
        ("drag_angular", f32, (nb,)),
        ("limit_stiffness", f32), ("limit_damping", f32), ("gravity", f32),
        ("contact_kp", f32), ("contact_kd", f32), ("contact_fmax", f32),
        ("friction_mu", f32), ("friction_kt", f32), ("max_qd", f32),
        ("motor_omega_max", f32), ("dt_sub", f32), ("root_mass", f32),
    ])


def pack_params(model: PlanarModel) -> np.ndarray:
    """The model as the kernel's parameter block (a one-element record)."""
    nd, nb, ng, na = kernel_shape(model)
    if nb > 31:
        raise ValueError(f"the kernel takes at most 31 bodies, got {nb}")
    rec = np.zeros(1, _param_dtype(nd, nb, ng, na))[0]
    chains = batched._ancestors(model)
    rec["parent"] = model.parent
    rec["anc_mask"] = [sum(1 << c for c in chain) for chain in chains]
    if ng:
        rec["geom_body"] = model.geom_body
        rec["geom_anc_mask"] = [rec["anc_mask"][b] for b in model.geom_body]
        rec["geom_pos"] = np.asarray(model.geom_pos).reshape(ng, 2)
        rec["geom_radius"] = model.geom_radius
    if na:
        rec["actuator_dof"] = model.actuator_dof
        rec["gear"] = model.gear
    rec["actuated_mask"] = sum(1 << d for d in set(model.actuator_dof))
    has_drag = len(model.drag_normal) > 0
    rec["has_drag"] = int(has_drag)
    rec["finite_motor"] = int(np.isfinite(model.motor_omega_max))
    rec["n_substeps"] = model.n_substeps
    for name in ("anchor", "com", "mass", "inertia"):
        rec[name] = getattr(model, name)
    # zero-length per-dof arrays are the dataclass defaults: none
    for name, fill in (("damping", 0.0), ("stiffness", 0.0), ("springref", 0.0),
                       ("limit_lo", -np.inf), ("limit_hi", np.inf)):
        rec[name] = batched._floats(getattr(model, name), nd, fill)
    if has_drag:
        for name in ("drag_normal", "drag_tangent", "drag_angular"):
            rec[name] = getattr(model, name)
    for name in ("limit_stiffness", "limit_damping", "gravity", "contact_kp",
                 "contact_kd", "contact_fmax", "friction_mu", "friction_kt",
                 "max_qd", "motor_omega_max"):
        rec[name] = float(getattr(model, name))
    rec["dt_sub"] = model.dt / model.n_substeps
    # the plain version sums a free root's translational mass in float64 and
    # rounds it once, where it meets a tensor
    rec["root_mass"] = sum(batched._floats(model.mass)) + 1e-6
    return np.array(rec)


def _check_inputs(model: PlanarModel, Q, QD, ACTS):
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


def rollout_planar_reference(model: PlanarModel, Q, QD, ACTS):
    """The plain version: ``batched.step_rows`` looped over the horizon."""
    _check_inputs(model, Q, QD, ACTS)
    chains = batched._ancestors(model)
    q, qd = list(Q.T), list(QD.T)
    qs, qds = [], []
    for t in range(ACTS.shape[1]):
        q, qd = batched.step_rows(model, q, qd, list(ACTS[:, t].T), chains)
        qs.append(torch.stack(q, dim=1))
        qds.append(torch.stack(qd, dim=1))
    return torch.stack(qs), torch.stack(qds)


# B1's two instantiations (csrc/planar_rollout.cu), by their LATENCY index
THROUGHPUT, LATENCY = 0, 1
THROUGHPUT_LANES = 2
# The latency instantiation runs while its warps fit the card at this many an
# SM, two a scheduler. The sweep of both instantiations over P on the H100
# (PERF.md §6) puts the crossover at 11.6-23 warps an SM by shape: the
# 16-lane shapes' where their resident warps fill one wave, the Hopper's
# first, its throughput instantiation being the leanest.
LATENCY_WARPS_PER_SM = 8


def latency_lanes(shape) -> int:
    """G of the latency instantiation at ``shape`` <NDOF, NBODY, NGEOM, NACT>
    (csrc/planar_step.cuh::planar_latency_lanes): the smallest power of two
    that holds the largest item count, so each phase's item loop is one pass."""
    g = THROUGHPUT_LANES
    while g < max(shape):
        g *= 2
    return g


def takes_latency(P: int, shape, sms: int) -> bool:
    """Whether a launch of P rows at ``shape`` on a card of ``sms`` SMs takes
    the latency instantiation: its warps, 32 / G trajectories each, fit at
    LATENCY_WARPS_PER_SM an SM. Otherwise the throughput one (G = 2)."""
    per_warp = 32 // latency_lanes(shape)
    return -(-P // per_warp) <= LATENCY_WARPS_PER_SM * sms


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# id(model) -> (model, (throughput kernel, latency kernel)). The entry holds
# the model, so its id cannot be reused by another model while it lives.
_LAUNCHERS: dict = {}


def _launchers(model: PlanarModel):
    """The model's two bound kernels (``bind``), resolved and packed once per
    model, so that a launch only makes the ctypes call."""
    hit = _LAUNCHERS.get(id(model))
    if hit is not None and hit[0] is model:
        return hit[1]
    from icem_torch.ops._build import load_library

    lib = load_library()[0]
    kernels = (bind(lib, model, THROUGHPUT), bind(lib, model, LATENCY))
    _LAUNCHERS[id(model)] = (model, kernels)
    return kernels


def bind(lib, model: PlanarModel, latency: int = THROUGHPUT):
    """(fn, params): the C launcher of the model's shape and the given
    instantiation (THROUGHPUT or LATENCY) in ``lib`` (a ctypes.CDLL of
    ``csrc/planar_rollout.cu``) and the model's packed parameter block."""
    shape = "_".join(map(str, kernel_shape(model)))
    try:
        fn = getattr(lib, f"planar_rollout_{shape}_{int(latency)}")
        nbytes = getattr(lib, f"planar_params_bytes_{shape}")
    except AttributeError:
        raise ValueError(
            f"the rollout kernel is not instantiated for the shape "
            f"<NDOF, NBODY, NGEOM, NACT> = <{shape.replace('_', ', ')}>; add it "
            f"to csrc/planar_rollout.cu") from None
    fn.restype = ctypes.c_int
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, ptr, ll, ptr, ll, ptr, ptr, ptr, ll, ctypes.c_int, ptr]
    nbytes.restype = ctypes.c_int
    params = pack_params(model)
    if params.nbytes != nbytes():
        raise RuntimeError(f"parameter block is {params.nbytes} bytes, the kernel "
                           f"expects {nbytes()}")
    return fn, params


def occupancy(lib, ptxas_log: str, model: PlanarModel, latency: int = THROUGHPUT) -> dict:
    """The resources of one instantiation (THROUGHPUT or LATENCY) at the
    model's shape, from a build of ``csrc/planar_rollout.cu`` (``lib``, a
    ctypes.CDLL, and its ptxas log): registers, stack and spill bytes, the
    lanes per trajectory, dynamic shared memory per block and the warps an SM
    holds at once."""
    from icem_torch.ops import _build

    shape = (*kernel_shape(model), int(latency))
    lanes = getattr(lib, "planar_lanes_" + "_".join(map(str, shape)))
    lanes.restype, lanes.argtypes = ctypes.c_int, []
    return dict(_build.occupancy(lib, ptxas_log, "planar", shape),
                shape=", ".join(map(str, kernel_shape(model))), lanes=lanes())


def launch_bound(kernel, Q, QD, ACTS):
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
    fn, params = kernel
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        # the block goes by value, into the kernel's constant bank
        err = fn(params.ctypes.data, q0.data_ptr(), q0.stride(0), qd0.data_ptr(), qd0.stride(0),
                 acts.data_ptr(), qs.data_ptr(), qds.data_ptr(), P, h, stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: cudaError_t {err}")
    return qs, qds


def _launch(model: PlanarModel, Q, QD, ACTS):
    """One launch of the instantiation ``takes_latency`` picks, counted as
    ``b1.launches`` (and ``b1.launches.latency`` on the latency one) and its
    rows as ``b1.rows``."""
    P = ACTS.shape[0]
    latency = takes_latency(P, kernel_shape(model), _sm_count(Q.device.index))
    out = launch_bound(_launchers(model)[latency], Q, QD, ACTS)
    metrics.count("b1.launches")
    if latency:
        metrics.count("b1.launches.latency")
    metrics.count("b1.rows", P)
    return out


def rollout_planar(model: PlanarModel, Q, QD, ACTS):
    """Open-loop rollout. Q, QD: [P, ndof] float32; ACTS: [P, h, n_act]
    float32, already clipped. Returns (qs, qds): [h, P, ndof].

    CUDA tensors go through the kernel (and raise if it cannot run); CPU
    tensors through the plain version.
    """
    _check_inputs(model, Q, QD, ACTS)
    if Q.device.type == "cuda":
        return _launch(model, Q, QD, ACTS)
    if Q.device.type == "cpu":
        return rollout_planar_reference(model, Q, QD, ACTS)
    raise ValueError(f"rollout_planar runs on cuda or cpu, got {Q.device}")
