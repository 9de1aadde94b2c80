"""Open-loop policy: precomputed action sequences as a controller.

Counterpart of ``icem_tpu/controllers/open_loop.py`` (numpy only, so the port
keeps its own copy): replays a [h, d] plan or a [p, h, d] population of
plans one column at a time, for recorded plans or expert data. The planners
roll action tensors through ``models/base.py::rollout_open_loop`` directly.
"""

from __future__ import annotations

import numpy as np


class OpenLoopPolicy:
    """Replay a [h, d] plan or a [p, h, d] population of plans."""

    needs_forward_model = False

    def __init__(self, action_sequences, *, env=None, **kwargs):
        seq = np.asarray(action_sequences, np.float32)
        if seq.ndim == 2:
            seq = seq[None]
        if seq.ndim != 3:
            raise ValueError(f"expected [h,d] or [p,h,d] actions, got {seq.shape}")
        self.action_sequences = seq
        self._t = 0

    @property
    def population(self) -> int:
        return self.action_sequences.shape[0]

    @property
    def horizon(self) -> int:
        return self.action_sequences.shape[1]

    def beginning_of_rollout(self, *, observation=None, state=None, mode="train"):
        self._t = 0

    def end_of_rollout(self, total_time, total_return, mode):
        pass

    def get_action(self, obs=None, state=None, mode="train"):
        """The next action column; past the horizon the last action repeats
        (replay saturates, which the episode loop needs where the plan is
        shorter than the episode)."""
        t = min(self._t, self.horizon - 1)
        self._t += 1
        col = self.action_sequences[:, t, :]
        return col[0] if self.population == 1 else col

    def get_parallel_policy_copy(self, indices):
        """The plans of the population rows ``indices``."""
        return OpenLoopPolicy(self.action_sequences[np.asarray(indices)])
