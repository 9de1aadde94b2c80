"""Checkpoint / resume / elastic restart.

Counterpart of ``icem_tpu/runtime/checkpoint.py`` (the reference's
CheckpointManager, icem/misc/initialization.py, and MainState,
icem/main.py:57-79):

- per-iteration checkpoint directories ``checkpoints_{step:03d}`` with a
  ``checkpoints_latest`` symlink re-pointed on finalize
- load modes: False / True / "auto" (load if a checkpoint exists)
- artifacts: main state (iteration, successful rollouts, metric step
  counters), rollout buffers, forward model, controller, reward dict
- ``restart_every_n_iter`` elastic-restart window for cluster requeueing

Serialization is npz for array state and pickle for buffers. Planner state
is packed by ``pack_pytree``: tensors become numpy arrays, and a
``torch.Generator`` its state with its device type, so that a checkpoint
written on the card loads on the card. The JAX package's checkpoints are
not read: its PRNG streams are not torch's.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch


class _PackedGenerator:
    """Pickle-safe state of a ``torch.Generator`` and its device type."""

    def __init__(self, state: np.ndarray, device_type: str):
        self.state = state
        self.device_type = device_type


def tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, NamedTuples, lists and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pack_pytree(tree):
    """Tensors -> numpy arrays, generators -> _PackedGenerator; other leaves
    (Python scalars, None) stay. Inverse: unpack_pytree."""

    def f(x):
        if isinstance(x, torch.Generator):
            return _PackedGenerator(x.get_state().numpy(), x.device.type)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return tree_map(f, tree)


def unpack_pytree(tree, device):
    """Restore a pack_pytree tree onto ``device``. A generator is restored
    only onto a device of the type it was saved from: the CPU's and the
    card's generators keep different states."""
    device = torch.device(device)

    def f(x):
        if isinstance(x, _PackedGenerator):
            if x.device_type != device.type:
                raise ValueError(f"a {x.device_type} generator state cannot be restored "
                                 f"onto a {device.type} device")
            gen = torch.Generator(device=device)
            gen.set_state(torch.from_numpy(x.state))
            return gen
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        return x

    return tree_map(f, tree)


class MainState:
    """Training-loop progress (main.py:57-79)."""

    def __init__(self, iteration: int = 0, successful_rollouts: int = 0,
                 metric_steps: Optional[dict] = None):
        self.iteration = iteration
        self.successful_rollouts = successful_rollouts
        self.metric_steps = metric_steps or {}

    def save(self, path: str):
        np.savez(path, iteration=self.iteration,
                 successful_rollouts=self.successful_rollouts,
                 metric_steps=np.array(list(self.metric_steps.items()), dtype=object))
        print(f"checkpointing at iteration {self.iteration}")

    def load(self, path: str):
        dat = np.load(path, allow_pickle=True)
        self.iteration = int(dat["iteration"])
        self.successful_rollouts = int(dat["successful_rollouts"])
        self.metric_steps = {k: int(v) for k, v in dat["metric_steps"]}
        self.iteration += 1  # resume with the NEXT iteration (main.py:78)
        print(f"loaded checkpoint and starting at iteration {self.iteration}")


class CheckpointManager:
    """reference: misc/initialization.py:20-181."""

    CHECKPOINT_PREFIX = "checkpoints"

    def __init__(self, *, model_dir: str, load=False, save=True,
                 save_every_n_iter: int = 1, restart_every_n_iter=None,
                 keep_only_last: bool = False, exclude_rollouts: bool = False,
                 **kwargs):
        self.model_dir = model_dir
        self.load = load
        self.save = save
        self.save_every_n_iter = max(int(save_every_n_iter or 1), 1)
        self.restart_every_n_iter = restart_every_n_iter
        self.keep_only_last = keep_only_last
        self.exclude_rollouts = exclude_rollouts
        self.were_buffers_loaded = False
        self._current_dir: Optional[str] = None
        self._previous_dir: Optional[str] = None

        self._load_dir = self._check_for_latest() if self._should_load() else None

    # ------------------------------------------------------------------ #
    @property
    def do_restarting(self) -> bool:
        return self.restart_every_n_iter is not None

    def _should_load(self) -> bool:
        if self.load == "auto":
            return self._check_for_latest() is not None
        return bool(self.load)

    def _latest_link(self) -> str:
        return os.path.join(self.model_dir, f"{self.CHECKPOINT_PREFIX}_latest")

    def _check_for_latest(self) -> Optional[str]:
        """Prefer the _latest symlink; else the highest-numbered dir
        (initialization.py:71-74)."""
        link = self._latest_link()
        if os.path.isdir(link):
            return link
        if not os.path.isdir(self.model_dir):
            return None
        candidates = sorted(
            (d for d in os.listdir(self.model_dir)
             if d.startswith(self.CHECKPOINT_PREFIX + "_") and d[-1].isdigit()),
            # numeric sort: past 999 iterations the 03d padding stops
            # zero-aligning and a lexicographic sort would pick 999 over 1000
            key=lambda d: int(d.rsplit("_", 1)[-1]),
        )
        return os.path.join(self.model_dir, candidates[-1]) if candidates else None

    # ------------------------------------------------------------------ #
    def update_checkpoint_dir(self, step: int):
        self._previous_dir = self._current_dir
        self._current_dir = os.path.join(
            self.model_dir, f"{self.CHECKPOINT_PREFIX}_{step:03d}")
        os.makedirs(self._current_dir, exist_ok=True)

    def finalized_checkpoint(self):
        """Re-point the _latest symlink atomically (initialization.py:83-89)."""
        link = self._latest_link()
        tmp = link + ".tmp"
        if os.path.islink(tmp) or os.path.exists(tmp):
            os.remove(tmp)
        os.symlink(os.path.basename(self._current_dir), tmp)
        os.replace(tmp, link)
        if self.keep_only_last and self._previous_dir \
                and os.path.isdir(self._previous_dir) \
                and self._previous_dir != self._current_dir:
            shutil.rmtree(self._previous_dir, ignore_errors=True)

    # -- artifact save/load ------------------------------------------------ #
    def _path(self, base: Optional[str], name: str) -> Optional[str]:
        return None if base is None else os.path.join(base, name)

    def save_main_state(self, main_state: MainState):
        main_state.save(self._path(self._current_dir, "main_state.npz"))

    def load_main_state(self, main_state: MainState):
        p = self._path(self._load_dir, "main_state.npz")
        if p and os.path.exists(p):
            main_state.load(p)

    def store_buffer(self, *, rollout_buffer, suffix: str = ""):
        if self.exclude_rollouts:
            return
        with open(self._path(self._current_dir, f"rollout_buffer{suffix}.pkl"), "wb") as f:
            pickle.dump(rollout_buffer, f)

    def load_buffer(self, *, rollout_buffer, suffix: str = ""):
        p = self._path(self._load_dir, f"rollout_buffer{suffix}.pkl")
        if p and os.path.exists(p):
            with open(p, "rb") as f:
                loaded = pickle.load(f)
            rollout_buffer.extend(loaded)
            self.were_buffers_loaded = True

    def store_forward_model(self, forward_model):
        if forward_model is not None:
            forward_model.save(self._path(self._current_dir, "forward_model"))

    def load_forward_model(self, forward_model):
        if forward_model is not None and self._load_dir:
            p = self._path(self._load_dir, "forward_model")
            # a checkpoint of a model without weights has no model file: keep
            # the fresh model rather than fail the resume
            if os.path.exists(p):
                forward_model.load(p)
            else:
                print(f"no forward-model file in checkpoint {self._load_dir}; "
                      f"keeping the fresh model")

    def store_controller(self, controller):
        if controller is not None:
            controller.save(self._path(self._current_dir, "controller"))

    def load_controller(self, controller):
        if controller is not None and self._load_dir:
            p = self._path(self._load_dir, "controller")
            if os.path.exists(p):
                controller.load(p)

    def save_reward_dict(self, reward_dict: dict):
        np.save(self._path(self._current_dir, "reward_info.npy"),
                np.array([reward_dict], dtype=object))

    def load_reward_dict(self, reward_dict: dict) -> dict:
        p = self._path(self._load_dir, "reward_info.npy")
        if p and os.path.exists(p):
            loaded = np.load(p, allow_pickle=True)[0]
            reward_dict.update(loaded)
        return reward_dict
