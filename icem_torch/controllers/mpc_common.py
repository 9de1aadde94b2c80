"""Shared MPC controller behavior.

Counterpart of ``icem_tpu/controllers/mpc_common.py``: every model-based MPC
controller (iCEM, vanilla CEM, random shooting) can check that its
ground-truth forward model's state still agrees with the live env state
(``verbose``), advances a stateful model by each executed action, and the
CEM planners share their checkpoint format and their sharded planning.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import asdict

from icem_torch.models.base import batch_tree, unbatch_tree
from icem_torch.runtime.checkpoint import pack_pytree, unpack_pytree

CONSISTENCY_TOL = 1e-5


class ModelConsistencyMixin:
    """``check_model_consistency`` for controllers that keep a
    ``_model_state`` synced to reality and hold ``self.env`` and
    ``self.forward_model``.

    The JAX controllers advance the synced model state by every executed
    action. The port does so where it matters (``_after_action``): for a
    ``stateful`` model (the RSSM, whose filter keeps the advanced ``h``),
    and under ``verbose``, so that the next step's check compares the
    ground-truth model's prediction with the real state. Otherwise the next
    sync replaces the state and the advance would only cost a step of the
    model.
    """

    def check_model_consistency(self, env_state):
        """Warn if the forward model's state differs from the live env state
        by more than ``CONSISTENCY_TOL``. Returns the difference (one host
        read), or None where no env state or model state is held or the
        model is learned (its state is not an env state)."""
        if (env_state is None or self._model_state is None
                or self.forward_model.apply_fn is not None):
            return None
        diff = float(self.env.compute_state_difference(env_state, self._model_state))
        if diff > CONSISTENCY_TOL:
            print(f"Warning: internal forward model differs from env: {diff}")
        return diff

    def _advance_model(self, obs, action):
        """Step the synced model state by the executed action."""
        if self._model_state is not None:
            ms, _, _ = self.forward_model.predict_fn(batch_tree(self._model_state), obs[None],
                                                     action[None])
            self._model_state = unbatch_tree(ms)

    def _planner_fn(self):
        """What the planner rolls out: a learned model's ``apply_fn``, bound
        to the weights it is given, else the model's ``predict_fn``."""
        fm = self.forward_model
        return fm.predict_fn if fm.apply_fn is None else fm.apply_fn

    @property
    def live_model_params(self):
        """The learned model's live weights to feed the planner; None for
        the ground-truth models."""
        return self.forward_model.params

    def _after_action(self, obs, action):
        """The model advance after an executed action (see the class)."""
        if self.verbose or self.forward_model.stateful:
            self._advance_model(obs, action)


class ShardedPlannerMixin:
    """What the CEM planners share for ``sharded``: a planner with a
    process group ``_group`` plans through ``_plan_impl()``, a
    ``parallel/plan.py::ShardedPlan``; every other one through a compiled
    ``plan_step``. Needs ``_group``, ``device``, ``forward_model`` and
    ``_plan_impl``."""

    @property
    def plans_eagerly(self) -> bool:
        """True for a sharded planner over a gloo group on the card: its
        gather goes through the host, which no CUDA graph captures, so its
        plan steps and the device episode's control steps run eagerly."""
        return (self._group is not None and self._group.backend == "gloo"
                and self.device.type == "cuda")

    @property
    def sharded_plan(self):
        """The ShardedPlan of a planner with a group, else None."""
        return None if self._group is None else self._plan_impl()

    def _announce_group(self):
        if self.plans_eagerly:
            print(f"{type(self).__name__}: a gloo group on the card plans eagerly (its gather "
                  f"goes through the host; no CUDA graph)")

    def functional_plan(self):
        """(pstate, obs, env_state, model_params=None) -> (action, pstate'),
        on device tensors and with no host round trip but a gloo group's
        gather. A learned model's weights enter as ``model_params``
        (``live_model_params``); the model state is synced from the
        observation at every step, as in the JAX package. A sharded
        controller plans sharded episodes."""
        plan_impl = self._plan_impl()
        init_model_state = self.forward_model.init_model_state

        def plan(pstate, obs, env_state, model_params=None):
            res = plan_impl(pstate, obs, init_model_state(obs, env_state), model_params)
            return res.action, res.state

        return plan


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
