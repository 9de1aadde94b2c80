"""Forward-model abstraction: batched one-step predictors and open-loop rollouts.

Counterpart of ``icem_tpu/models/base.py``. PyTorch has no ``vmap`` in this
port: a predictor takes a leading population axis itself, and the rollout
over the horizon is a Python loop, or one call where the predictor carries a
whole-horizon ``.rollout`` (the planar envs: one kernel launch).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from icem_torch.runtime.checkpoint import tree_map


class TrajectoryBatch(NamedTuple):
    """A batch of simulated trajectories, time-major.

    observations:      [h, p, obs_dim]  obs BEFORE each step
    next_observations: [h, p, obs_dim]  obs AFTER each step
    actions:           [h, p, act_dim]
    rewards:           [h, p]
    final_model_state: model state with a leading population axis
    """

    observations: torch.Tensor
    next_observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    final_model_state: Any


def broadcast_model_state(model_state, population: int):
    """Replicate a single model state (a tensor or a dict of them) across a
    population axis, as views."""
    return tree_map(lambda x: x.expand((population,) + tuple(x.shape)), model_state)


def batch_tree(model_state):
    """A single model state as a population of one."""
    return tree_map(lambda x: x[None], model_state)


def unbatch_tree(model_state):
    """The one member of a population of one."""
    return tree_map(lambda x: x[0], model_state)


def rollout_open_loop(predict_fn, model_state, obs, actions) -> TrajectoryBatch:
    """Roll a population of open-loop action sequences through a model.

    predict_fn: (model_state [p, ...], obs [p, obs_dim], action [p, act_dim])
                -> (model_state, next_obs, reward), optionally with a
                whole-horizon ``.rollout(model_states, actions)`` that
                returns the sequences or None to decline.
    model_state: unbatched (broadcast to p) or with a leading p axis.
    obs: [obs_dim] or [p, obs_dim] start observation(s).
    actions: [p, h, act_dim] action sequences.
    """
    p, h = actions.shape[0], actions.shape[1]
    # batching follows obs: an unbatched [obs_dim] start means the model
    # state is unbatched too
    if obs.ndim == 1:
        obs = obs.expand((p,) + tuple(obs.shape))
        model_state = broadcast_model_state(model_state, p)

    # whole-horizon fast path (the planar and spatial GT envs); it returns
    # None where it declines (action repeat), and the step loop runs instead
    whole = getattr(predict_fn, "rollout", None)
    out = None if whole is None else whole(model_state, actions)
    if out is not None:
        obs_seq, next_obs_seq, actions_tm, rewards, final_ms = out
        return TrajectoryBatch(
            observations=obs_seq, next_observations=next_obs_seq,
            actions=actions_tm, rewards=rewards, final_model_state=final_ms)

    actions_tm = actions.transpose(0, 1)  # [h, p, d] time-major
    obs_seq, next_obs_seq, rew_seq = [], [], []
    ms, ob = model_state, obs
    for t in range(h):
        ms, ob2, rew = predict_fn(ms, ob, actions_tm[t])
        obs_seq.append(ob)
        next_obs_seq.append(ob2)
        rew_seq.append(rew)
        ob = ob2
    return TrajectoryBatch(
        observations=torch.stack(obs_seq),
        next_observations=torch.stack(next_obs_seq),
        actions=actions_tm,
        rewards=torch.stack(rew_seq),
        final_model_state=ms,
    )


def trajectory_cost(cost_fn, traj: TrajectoryBatch, mode: str = "sum",
                    use_env_reward_as_cost: bool = False) -> torch.Tensor:
    """Per-trajectory scalar cost. mode: 'sum' | 'best' (min over time) |
    'final'. Returns [p]."""
    if use_env_reward_as_cost:
        costs_path = -traj.rewards  # [h, p]
    else:
        costs_path = cost_fn(traj.observations, traj.actions, traj.next_observations)
    if mode == "sum":
        return torch.sum(costs_path, dim=0)
    if mode == "best":
        return torch.amin(costs_path, dim=0)
    if mode == "final":
        return costs_path[-1]
    raise NotImplementedError(f"unknown cost_along_trajectory mode {mode!r}")


class ForwardModel:
    """Forward-model interface: ``predict_fn`` (batched over a leading
    population axis) and the sync of its state to reality.

    Learned models also expose ``params``, their live weights as a dict of
    tensors that share storage with the trained ones, and
    ``apply_fn(params, model_state, obs, action)``, the core with the weights
    as its first argument: the planners bind the weights they are given.
    ``stateful``: the model state carries what the model learned of the past
    (the RSSM's ``h``), so the controllers advance it by each executed
    action before the next sync.
    """

    params = None
    apply_fn = None
    version = 0  # bumped by train() and load()
    stateful = False

    def __init__(self, *, env, **kwargs):
        self.env = env

    # -- functional core ---------------------------------------------------
    def predict_fn(self, model_state, obs, action):
        """(model_state, obs, action) -> (next_model_state, next_obs, reward)."""
        raise NotImplementedError

    def init_model_state(self, observation, env_state=None):
        """Model state given a fresh observation (and env GT state if known)."""
        raise NotImplementedError

    def got_actual_observation_and_env_state(self, *, observation, env_state=None,
                                             model_state=None):
        """Sync the model to reality at the start of each planning step."""
        return self.init_model_state(observation, env_state)

    def graph_reads(self):
        """The generators and tensors that ``predict_fn`` and ``apply_fn``
        reach through the model rather than through their arguments: a
        compiled step registers the generators and keys on the tensors'
        addresses (``runtime/graphs.py``). Empty for a model without them."""
        return ()

    # -- driver lifecycle (no-ops for models without weights) ---------------
    def train(self, buffer):
        return {}

    def save(self, path):
        return None

    def load(self, path):
        return None
