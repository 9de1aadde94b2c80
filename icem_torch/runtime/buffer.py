"""Rollout data structures.

Copy of ``icem_tpu/runtime/buffer.py``, which imports no JAX; the port keeps
its own. Host-side equivalents of the reference's Rollout / RolloutBuffer
(icem/misc/rolloutbuffer.py): a Rollout is one episode as a dict of
[time, ...] numpy arrays over a whitelisted field set; a RolloutBuffer is a
sequence of Rollouts with cached flat concatenation, train/test splitting,
reward statistics and optional bounded-size FIFO eviction (the reference's
_CustomList). Episodes run on the device become Rollouts only at the host
boundary (``runtime/rollout.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

ALLOWED_FIELDS = (
    "observations", "next_observations", "actions", "rewards", "dones",
    "costs", "env_states", "model_states", "successes",
)


class Rollout:
    """One episode/trajectory (misc/rolloutbuffer.py:9-54)."""

    def __init__(self, field_names: Sequence[str] = None, transitions: Iterable = None,
                 data: Dict[str, np.ndarray] = None):
        if data is not None:
            fields = dict(data)
        else:
            fields = {}
            if field_names and transitions is not None:
                cols = list(zip(*transitions)) if transitions else \
                    [[] for _ in field_names]
                for name, col in zip(field_names, cols):
                    fields[name] = col
        bad = set(fields) - set(ALLOWED_FIELDS)
        if bad:
            raise ValueError(f"unknown rollout fields {bad}; allowed: {ALLOWED_FIELDS}")
        self._data: Dict[str, np.ndarray] = {}
        # env/model states may be arbitrary pytrees: keep as object lists
        self._side: Dict[str, list] = {}
        for k, v in fields.items():
            if k in ("env_states", "model_states"):
                self._side[k] = list(v)
            else:
                self._data[k] = np.asarray(v)

    @classmethod
    def from_dict(cls, **fields):
        return cls(data=fields)

    @property
    def field_names(self):
        return tuple(self._data.keys()) + tuple(self._side.keys())

    def __len__(self):
        if self._data:
            return len(next(iter(self._data.values())))
        if self._side:
            return len(next(iter(self._side.values())))
        return 0

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self._side:
                return self._side[key]
            return self._data[key]
        # integer/slice indexing over time
        out = {k: v[key] for k, v in self._data.items()}
        return out

    def __contains__(self, key):
        return key in self._data or key in self._side

    def cost_to_go(self, t=None, discount: float = 1.0):
        """Reward-suffix aggregate (misc/rolloutbuffer.py:53-54).

        With ``t`` given: scalar ``sum_i rewards[i] * discount**(t - i)`` for
        i in [t, T) — the reference's exact formula, including its inverted
        exponent sign (discount < 1 up-weights later rewards). Without ``t``:
        the full vector of undiscounted suffix sums (one per start index).
        """
        rewards = self._data["rewards"]
        if t is None:
            return np.cumsum(rewards[::-1])[::-1]
        t = int(t)
        i = np.arange(t, len(rewards))
        return float(np.sum(rewards[t:] * float(discount) ** (t - i)))

    def as_dict(self):
        return dict(self._data)


class RolloutBuffer:
    """Sequence of Rollouts (misc/rolloutbuffer.py:124-281).

    max_size bounds the TOTAL number of transitions; oldest rollouts are
    evicted FIFO when exceeded (the reference's _CustomList semantics,
    rolloutbuffer.py:58-120).
    """

    def __init__(self, rollouts: Union[Sequence[Rollout], "RolloutBuffer", None] = None,
                 max_size: Optional[int] = None):
        self.max_size = max_size
        self._rollouts: List[Rollout] = []
        self._flat_cache = None
        self.latest_rollouts_added = 0
        if rollouts is not None:
            self.extend(rollouts)

    # -- list-ish interface -------------------------------------------------
    def __len__(self):
        return len(self._rollouts)

    def __bool__(self):
        return len(self._rollouts) > 0

    def __iter__(self):
        return iter(self._rollouts)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.flat[key]
        if isinstance(key, (int, np.integer)):
            return self._rollouts[key]
        if isinstance(key, slice):
            return RolloutBuffer(rollouts=self._rollouts[key])
        # fancy indexing with an index array
        idx = np.asarray(key)
        return RolloutBuffer(rollouts=[self._rollouts[int(i)] for i in idx])

    def append(self, rollout: Rollout):
        self._rollouts.append(rollout)
        self.latest_rollouts_added = 1
        self._flat_cache = None
        self._evict()

    def extend(self, rollouts):
        items = list(rollouts)
        self._rollouts.extend(items)
        self.latest_rollouts_added = len(items)
        self._flat_cache = None
        self._evict()

    def clear(self):
        self._rollouts.clear()
        self._flat_cache = None

    def _evict(self):
        if self.max_size is None:
            return
        total = sum(len(r) for r in self._rollouts)
        # never evict down to nothing: a single episode longer than max_size
        # stays (otherwise fresh data would be silently discarded)
        while len(self._rollouts) > 1 and total > self.max_size:
            total -= len(self._rollouts[0])
            self._rollouts.pop(0)
            self._flat_cache = None

    # -- flat views ----------------------------------------------------------
    @property
    def flat(self) -> Dict[str, np.ndarray]:
        """All transitions concatenated; on heterogeneous rollouts falls back
        to the common field subset (rolloutbuffer.py:156-172)."""
        if self._flat_cache is None:
            if not self._rollouts:
                self._flat_cache = {}
            else:
                common = set(self._rollouts[0]._data.keys())
                for r in self._rollouts[1:]:
                    common &= set(r._data.keys())
                self._flat_cache = {
                    k: np.concatenate([r._data[k] for r in self._rollouts], axis=0)
                    for k in common
                }
        return self._flat_cache

    def as_array(self, key: str) -> np.ndarray:
        """[rollouts, time, dim] stacked field (rolloutbuffer.py:193-205).
        Requires equal-length rollouts."""
        if not self._rollouts:
            raise TypeError("empty rollout buffer")
        return np.stack([r._data[key] for r in self._rollouts], axis=0)

    def split(self, fraction: float, key=None):
        """Random train/test split over rollouts (rolloutbuffer.py:180-191)."""
        rng = np.random.default_rng(key)
        n = len(self._rollouts)
        perm = rng.permutation(n)
        n_train = int(round(n * fraction))
        train = RolloutBuffer(rollouts=[self._rollouts[i] for i in perm[:n_train]])
        test = RolloutBuffer(rollouts=[self._rollouts[i] for i in perm[n_train:]])
        return train, test

    # -- reward statistics (rolloutbuffer.py:249-274) -------------------------
    def _nonempty(self):
        """Zero-length rollouts (first-step physics blow-ups) carry no reward
        samples; statistics skip them instead of crashing np.max on (0,)."""
        return [r for r in self._rollouts if len(r) > 0]

    @property
    def mean_avg_reward(self):
        rs = self._nonempty()
        return float(np.mean([np.mean(r["rewards"]) for r in rs])) if rs else float("nan")

    @property
    def mean_max_reward(self):
        rs = self._nonempty()
        return float(np.mean([np.max(r["rewards"]) for r in rs])) if rs else float("nan")

    @property
    def mean_return(self):
        rs = self._nonempty()
        return float(np.mean([np.sum(r["rewards"]) for r in rs])) if rs else float("nan")

    @property
    def std_return(self):
        rs = self._nonempty()
        return float(np.std([np.sum(r["rewards"]) for r in rs])) if rs else float("nan")

