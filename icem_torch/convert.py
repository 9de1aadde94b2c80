"""Carry state from plain arrays into the port.

The ground-truth model has no learned weights: what a run carries is the
physics model's constants and the planner's state. Both arrive here as dicts
of plain values (numpy arrays, Python scalars and tuples), for example a
model's fields from ``dataclasses.asdict`` or a planner state's
``_asdict()``, converted to numpy. Float constants are rounded to float32
once, as they are where the JAX package meets them with x64 off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icem_torch.controllers.icem import ICemState
from icem_torch.envs.physics.planar import PlanarModel

_INT_TUPLES = ("parent", "geom_body", "actuator_dof")


def planar_model_from_arrays(fields: dict) -> PlanarModel:
    """A ``PlanarModel`` from its fields; unknown fields raise."""
    known = {f.name: f for f in dataclasses.fields(PlanarModel)}
    unknown = set(fields) - set(known)
    if unknown:
        raise ValueError(f"unknown PlanarModel fields {sorted(unknown)}")
    out = {}
    for name, value in fields.items():
        default = known[name].default
        if name in _INT_TUPLES:
            out[name] = tuple(int(v) for v in np.asarray(value).reshape(-1))
        elif isinstance(default, bool):
            out[name] = bool(value)
        elif isinstance(default, int):
            out[name] = int(value)
        elif isinstance(default, float):
            out[name] = float(value)
        else:
            out[name] = np.asarray(value, np.float32)
    return PlanarModel(**out)


def icem_state_from_arrays(fields: dict, device, generator: torch.Generator) -> ICemState:
    """An ``ICemState`` on ``device`` from its array fields. A PRNG key among
    the fields is not carried: ``generator`` is the state's random stream."""
    device = torch.device(device)

    def f32(name):
        return torch.tensor(np.asarray(fields[name], np.float32), device=device)

    return ICemState(
        mean=f32("mean"),
        std=f32("std"),
        elite_actions=f32("elite_actions"),
        elite_costs=f32("elite_costs"),
        elite_last_obs=f32("elite_last_obs"),
        have_elites=bool(np.asarray(fields["have_elites"])),
        generator=generator,
    )
