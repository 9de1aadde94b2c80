"""Shared step plumbing for planar-engine environments.

Counterpart of ``icem_tpu/envs/planar_base.py``. Every physics step, the real
env step included, goes through ``ops/planar_rollout.py::rollout_planar``: the
CUDA kernel on a CUDA tensor, the plain row engine on a CPU tensor. A real
step is a rollout of one trajectory over one control step; a planner's
population rollout is one launch over the whole horizon. With action repeat
the whole-horizon rollout declines (returns None), as the JAX one does, and
the caller steps the repeated ``step_batched``: one launch with h = 1 per
sub-step.

Subclasses implement ``_post_step(state, new_state, action) -> (obs, reward,
done)`` over leading batch dimensions; the state layout is
[q(ndof), qd(ndof), extra...] (extra = non-dynamic state, passed through).
"""

from __future__ import annotations

import torch

from icem_torch.envs.base import Env
from icem_torch.ops.planar_rollout import rollout_planar


class PlanarEnv(Env):
    """Env whose dynamics live on the planar engine."""

    def _post_step(self, state, new_state, action):
        """(obs, reward, done) from the transition; action arrives clipped."""
        raise NotImplementedError

    def _physics(self, states, actions):
        """[P, S] states under clipped [P, h, A] actions -> (qs, qds) [h, P, nd]."""
        nd = self.model.ndof
        return rollout_planar(self.model, states[:, :nd], states[:, nd: 2 * nd],
                              actions.contiguous())

    def step(self, state, action):
        # the raw population step: action repeat wraps this method itself
        new_states, obs, rewards, dones = self._raw_step_batched(state[None], action[None])
        return new_states[0], obs[0], rewards[0], dones[0]

    def step_batched(self, states, actions):
        """Population step: (states [P,S], actions [P,A]) ->
        (new_states, obs, rewards, dones)."""
        if self.model.energy_valve:
            raise NotImplementedError(
                "the planar energy valve is not ported to icem_torch: the real "
                "step of a model with energy_valve=True has no kernel yet")
        nd = self.model.ndof
        acts = torch.clamp(actions, -1.0, 1.0)
        qs, qds = self._physics(states, acts[:, None, :])
        new_states = torch.cat([qs[0], qds[0], states[:, 2 * nd:]], dim=1)
        obs, rewards, dones = self._post_step(states, new_states, acts)
        return new_states, obs, rewards, dones

    def rollout_batched(self, states, actions):
        """Full open-loop rollout: one kernel launch for the whole horizon,
        then observations and rewards in one [h, P] batch.

        states: [P, S]; actions: [P, h, A]. Returns the rollout_open_loop
        contract: (obs_seq, next_obs_seq, actions_tm, rewards, final_states)
        with time-major [h, P, ...] sequences. None with action repeat: this
        path bypasses the repeated step, so the caller takes the per-step one.
        """
        if self.action_repeat != 1:
            return None
        h = actions.shape[1]
        nd = self.model.ndof
        acts = torch.clamp(actions, -1.0, 1.0)
        qs, qds = self._physics(states, acts)
        extra = states[:, 2 * nd:]
        extra_seq = extra[None].expand((h,) + extra.shape)
        next_states = torch.cat([qs, qds, extra_seq], dim=2)
        prev_states = torch.cat([states[None], next_states[:-1]], dim=0)
        final_states = next_states[-1]

        acts_tm = acts.transpose(0, 1)  # [h, P, A]
        next_obs_seq, rewards, _ = self._post_step(prev_states, next_states, acts_tm)
        obs_seq = self.observation(prev_states)
        return obs_seq, next_obs_seq, acts_tm, rewards, final_states
