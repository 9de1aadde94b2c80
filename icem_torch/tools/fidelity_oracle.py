"""MuJoCo-oracle dynamics fidelity harness.

Counterpart of ``scripts/fidelity_oracle.py``. The reference's ground-truth
forward model is MuJoCo (the wrapped gym env, icem/models/gt_model.py:59-102);
the port's engines are from-scratch Lagrangian integrators. For each flagship
env this exports the model to MJCF (``envs/physics/mjcf_export.py``:
kinematics, inertials and springs exact, contacts and limits structurally
mapped), steps the port's autodiff engine and MuJoCo from identical states
under identical action sequences, and records the per-step state drift in
three regimes per env:

- ``ballistic``: airborne, joints inside limits, no actuation; only
  integrator details differ (the per-control-step frozen mass matrix against
  MuJoCo's per-substep one, float32 against float64).
- ``smooth``: the same with a gentle drive.
- ``contact``: the env's real operating regime (a pose near the ground and
  actions of scale 0.5). MuJoCo realizes contacts and limits through its
  convex solver, the port through penalty forces: the drift curve here is
  the documented deviation.

The airborne regimes strip the DC-motor speed line, the energy valve and the
``max_qd`` rail, robustness features with no MJCF equivalent; the contact
regime keeps the shipped model but for the speed line, which the export
refuses.

Usage (MuJoCo runs on the host; the port's engine on ``--device``, the card
unless ``--device cpu`` is given):

    python -m icem_torch.tools.fidelity_oracle --out fidelity.json \\
        [--round 4] [--horizon 40] [--seeds 3] [--device cpu]

Writes ``{"envs": {env: {regime: {"q_rmse_mean": [...], "com_drift_mean":
[...], "divergence_step_5cm_mean": x, ...}}}, ...}`` to ``--out``. The
package imports without ``mujoco``: only ``main`` imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from icem_torch.device import resolve_device
from icem_torch.envs.physics import mjcf_export, planar, spatial


def _engine_runner(model, is_spatial, device):
    engine = spatial if is_spatial else planar

    def run(q0, qd0, actions):
        q = torch.as_tensor(q0, dtype=torch.float32, device=device)
        qd = torch.as_tensor(qd0, dtype=torch.float32, device=device)
        acts = torch.as_tensor(np.asarray(actions), dtype=torch.float32, device=device)
        out = []
        for a in acts:
            q, qd = engine.step(model, q, qd, a)
            out.append((q, qd))
        return [(q.cpu().numpy().astype(np.float64), qd.cpu().numpy().astype(np.float64))
                for q, qd in out]

    return run


def _mj_runner(mujoco, model, xml, is_spatial):
    m = mujoco.MjModel.from_xml_string(xml)

    def run(q0, qd0, actions):
        d = mujoco.MjData(m)
        if is_spatial:
            d.qpos[:] = mjcf_export.qpos_from_q_spatial(q0, model.free_root)
            d.qvel[:] = mjcf_export.qvel_from_qd_spatial(qd0, model.free_root)
        else:
            d.qpos[:] = q0
            d.qvel[:] = qd0
        out = []
        for a in actions:
            d.ctrl[:] = np.clip(a, -1.0, 1.0)
            for _ in range(model.n_substeps):
                mujoco.mj_step(m, d)
            if is_spatial:
                q = mjcf_export.q_from_qpos_spatial(d.qpos.copy(), model.free_root)
                qd = mjcf_export.qvel_from_qd_spatial(d.qvel.copy(), model.free_root)
            else:
                q, qd = d.qpos.copy(), d.qvel.copy()
            out.append((q, qd))
        return out

    return run


def make_runners(mujoco, model, is_spatial, device):
    """(the port's engine, MuJoCo) as functions (q0, qd0, actions) -> the
    [(q, qd)] after each control step, float64 on the host."""
    xml = (mjcf_export.spatial_to_mjcf(model) if is_spatial
           else mjcf_export.planar_to_mjcf(model))
    return (_engine_runner(model, is_spatial, device),
            _mj_runner(mujoco, model, xml, is_spatial))


def _com(model, q, is_spatial):
    """World COM of the whole tree (a chart-independent drift metric)."""
    engine = spatial if is_spatial else planar
    coms = engine.fk(model, torch.as_tensor(q, dtype=torch.float32))[0].numpy()
    mass = np.asarray(model.mass, np.float64)
    return (mass[:, None] * coms.astype(np.float64)).sum(0) / mass.sum()


def compare(model, q0, qd0, actions, is_spatial, runners):
    ours = runners[0](q0, qd0, actions)
    mjs = runners[1](q0, qd0, actions)
    q_rmse, com_drift = [], []
    div_step = nan_step = None
    for t, ((qa, _), (qb, _)) in enumerate(zip(ours, mjs)):
        if not (np.all(np.isfinite(qa)) and np.all(np.isfinite(qb))):
            # an engine left its valid domain (e.g. the Euler-chart
            # singularity under free tumbling): the curve ends here
            nan_step = t
            break
        q_rmse.append(float(np.sqrt(np.mean((qa - qb) ** 2))))
        com_drift.append(float(np.linalg.norm(_com(model, qa, is_spatial)
                                              - _com(model, qb, is_spatial))))
        if div_step is None and com_drift[-1] > 0.05:
            div_step = t
    return {"q_rmse": q_rmse, "com_drift": com_drift, "divergence_step_5cm": div_step,
            "nan_step": nan_step, "horizon": len(actions), "dt": float(model.dt)}


def _smooth_state(model, rng, is_spatial, air_z):
    """Airborne rest pose: joints at springref where sprung, else mid-limits;
    gentle tumble rates; the root ``air_z`` up, airborne for the horizon."""
    n = model.ndof
    q = 0.05 * rng.standard_normal(n)
    lo = np.asarray(model.limit_lo, np.float64)
    hi = np.asarray(model.limit_hi, np.float64)
    if lo.size:
        fin = np.isfinite(lo) & np.isfinite(hi)
        mid = np.where(fin, lo, 0.0) / 2.0 + np.where(fin, hi, 0.0) / 2.0
        span = np.where(fin, hi, 0.0) - np.where(fin, lo, 0.0)
        q[fin] = (mid + 0.1 * span * np.tanh(q))[fin]
    stiff = np.asarray(model.stiffness, np.float64)
    ref = np.asarray(model.springref, np.float64)
    if stiff.size:
        sprung = stiff > 0
        q[sprung] = ref[sprung]
    if model.free_root:
        q[2 if is_spatial else 1] = air_z
    qd = 0.05 * rng.standard_normal(n)
    return q, qd


def _contact_state(model, rng, is_spatial, air_z=None):
    n = model.ndof
    q = 0.05 * rng.standard_normal(n)
    lo = np.asarray(model.limit_lo, np.float64)
    hi = np.asarray(model.limit_hi, np.float64)
    if lo.size:
        fin = np.isfinite(lo) & np.isfinite(hi)
        mid = np.where(fin, lo, 0.0) / 2.0 + np.where(fin, hi, 0.0) / 2.0
        q[fin] = (mid + q)[fin]
    ref = np.asarray(model.springref, np.float64)
    if ref.size and np.any(ref != 0):
        q[: len(ref)] = np.where(ref != 0, ref, q[: len(ref)])
    if model.free_root:
        q[2 if is_spatial else 1] = 0.55 if is_spatial else 0.75
    qd = 0.05 * rng.standard_normal(n)
    return q, qd


def flagship_models():
    """{name: (model, is_spatial)}: the envs the JAX harness measures."""
    from icem_torch.envs.ant3d import make_ant3d_model
    from icem_torch.envs.cheetah import HalfCheetah
    from icem_torch.envs.hopper import Hopper
    from icem_torch.envs.humanoid3d import make_humanoid3d_model

    return {"ant3d": (make_ant3d_model(), True),
            "halfcheetah": (HalfCheetah().model, False),
            "hopper": (Hopper().model, False),
            "humanoid3d": (make_humanoid3d_model(chart_center_pitch=-np.pi / 4), True)}


def _strip_rails(model):
    """The airborne regimes' twin: robustness rails off."""
    return dataclasses.replace(model, motor_omega_max=np.inf, max_qd=np.inf,
                               energy_valve=False)


def _padded(rows):
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), np.nan)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m icem_torch.tools.fidelity_oracle",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True, help="path of the JSON file to write")
    parser.add_argument("--round", type=int, default=4, help="seeds are 1000 * round + i")
    parser.add_argument("--horizon", type=int, default=40)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="where the port's engine runs; default: the CUDA device")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    import mujoco

    results = {}
    for name, (model, is_spatial) in flagship_models().items():
        # keep ballistic / smooth airborne over the whole horizon
        t_total = args.horizon * float(model.dt)
        air_z = 0.5 * float(model.gravity) * t_total ** 2 + 3.0
        n_act = len(model.actuator_dof)
        gear_max = float(np.max(model.gear)) if n_act else 1.0
        stripped = _strip_rails(model)
        contact_model = dataclasses.replace(model, motor_omega_max=np.inf)
        airborne = make_runners(mujoco, stripped, is_spatial, device)
        runners = {"ballistic": airborne, "smooth": airborne,
                   "contact": make_runners(mujoco, contact_model, is_spatial, device)}
        per_env = {}
        for regime, mk_state, act_scale in (
                ("ballistic", _smooth_state, 0.0),
                # torque-normalized gentle drive (~5 Nm) keeps high-gear
                # morphologies out of their limits
                ("smooth", _smooth_state, min(0.1, 5.0 / gear_max)),
                ("contact", _contact_state, 0.5)):
            regime_model = contact_model if regime == "contact" else stripped
            agg = None
            for s in range(args.seeds):
                rng = np.random.default_rng(1000 * args.round + s)
                q0, qd0 = mk_state(model, rng, is_spatial, air_z)
                actions = act_scale * rng.standard_normal((args.horizon, n_act))
                r = compare(regime_model, q0, qd0, actions, is_spatial, runners[regime])
                agg = {k: [v] for k, v in r.items()} if agg is None else {
                    k: agg[k] + [v] for k, v in r.items()}
            div = [d if d is not None else args.horizon for d in agg["divergence_step_5cm"]]
            finals = [row[-1] for row in agg["com_drift"] if len(row)]
            per_env[regime] = {
                "seeds": args.seeds,
                "dt": agg["dt"][0],
                "horizon": agg["horizon"][0],
                "act_scale": act_scale,
                "q_rmse_mean": np.nanmean(_padded(agg["q_rmse"]), 0).tolist(),
                "com_drift_mean": np.nanmean(_padded(agg["com_drift"]), 0).tolist(),
                "com_drift_final_mean": float(np.mean(finals)) if finals else None,
                "divergence_step_5cm_mean": float(np.mean(div)),
                "nan_steps": agg["nan_step"],
            }
            fin = per_env[regime]["com_drift_final_mean"]
            print(f"{name}/{regime}: final com drift "
                  f"{fin if fin is None else round(fin, 4)} m over {args.horizon} steps "
                  f"({args.horizon * model.dt:.1f} s), 5cm-divergence at step "
                  f"{per_env[regime]['divergence_step_5cm_mean']:.1f}, nan_steps "
                  f"{agg['nan_step']}", flush=True)
        results[name] = per_env

    out = {
        "what": "per-step state drift of the icem_torch autodiff engines vs a MuJoCo oracle "
                "built from the same model parameters (mjcf_export)",
        "mujoco_version": mujoco.__version__,
        "device": str(device) if device.type == "cpu" else torch.cuda.get_device_name(device),
        "envs": results,
        "notes": [
            "ballistic/smooth: airborne + inside limits; only integrator details differ "
            "(per-control-step frozen mass matrix vs per-substep, f32 vs f64)",
            "contact: penalty contacts/limits (ours) vs complementarity solver (MuJoCo), "
            "a structural model difference, quantified here",
            "ballistic/smooth with motor_omega_max/energy_valve/max_qd stripped (no MJCF "
            "equivalent); contact keeps the shipped model but for motor_omega_max",
        ],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
