"""Shared MPC controller behavior.

Counterpart of ``icem_tpu/controllers/mpc_common.py``: every model-based MPC
controller (iCEM, vanilla CEM, random shooting) can check that its
ground-truth forward model's state still agrees with the live env state
(``verbose``), and the CEM planners share their checkpoint format.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import asdict

from icem_torch.runtime.checkpoint import pack_pytree, unpack_pytree

CONSISTENCY_TOL = 1e-5


class ModelConsistencyMixin:
    """``check_model_consistency`` for controllers that keep a
    ``_model_state`` synced to reality and hold ``self.env`` and
    ``self.forward_model``.

    The port's controllers re-sync the ground-truth model from reality at
    every step; under ``verbose`` they also advance it by the executed action
    (``_advance_model``), so the next step's check compares the model's
    prediction with the real state, as the JAX controllers do.
    """

    def check_model_consistency(self, env_state):
        """Warn if the forward model's state differs from the live env state
        by more than ``CONSISTENCY_TOL``. Returns the difference (one host
        read), or None where no env state or model state is held."""
        if env_state is None or self._model_state is None:
            return None
        diff = float(self.env.compute_state_difference(env_state, self._model_state))
        if diff > CONSISTENCY_TOL:
            print(f"Warning: internal forward model differs from env: {diff}")
        return diff

    def _advance_model(self, obs, action):
        """Step the synced model state by the executed action."""
        if self._model_state is not None:
            ms, _, _ = self.forward_model.predict_fn(self._model_state[None], obs[None],
                                                     action[None])
            self._model_state = ms[0]


class PlannerCheckpointMixin:
    """``save`` / ``load`` of a planner with a config dataclass ``cfg``, a
    planner state ``_pstate``, a synced ``_model_state`` and ``was_reset``:
    a resumed controller's next action equals the saved one's to the bit.
    ``_shape_fields``: the config fields that set the planner state's
    shapes; a checkpoint that differs in one keeps a fresh planner state."""

    _shape_fields: tuple = ()

    def save(self, path):
        state = {
            "cfg": asdict(self.cfg),
            "was_reset": self.was_reset,
            "pstate": pack_pytree(self._pstate) if self._pstate is not None else None,
            "model_state": pack_pytree(self._model_state)
            if self._model_state is not None else None,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load(self, path):
        """Restore what ``save`` wrote, onto this controller's device."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            state = pickle.load(f)
        saved_cfg = state.get("cfg") or {}
        cfg = asdict(self.cfg)
        # restoring across a change of a shape field would fail later, far
        # from the cause
        mismatched = {f: (saved_cfg.get(f), cfg[f]) for f in self._shape_fields
                      if saved_cfg.get(f) != cfg[f]}
        if saved_cfg != cfg:
            if mismatched:
                print(f"{type(self).__name__}.load: checkpoint planner shapes differ "
                      f"({mismatched}); keeping fresh planner state")
            else:
                print(f"{type(self).__name__}.load: checkpoint was written with a "
                      f"different controller config; restoring state anyway")
        self.was_reset = bool(state.get("was_reset", False))
        if state.get("pstate") is not None and not mismatched:
            self._pstate = unpack_pytree(state["pstate"], self.device)
        if state.get("model_state") is not None:
            self._model_state = unpack_pytree(state["model_state"], self.device)
