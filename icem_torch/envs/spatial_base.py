"""Shared step plumbing for spatial-engine (3D) environments.

Counterpart of ``icem_tpu/envs/spatial_base.py``. Every physics step, the real
env step included, goes through ``ops/spatial_rollout.py::rollout_spatial``:
the CUDA kernel on a CUDA tensor, the plain row engine on a CPU tensor. A real
step is a rollout of one trajectory over one control step; a planner's
population rollout is one launch over the whole horizon, at any population.

Subclasses implement ``_post_step(state, new_state, action) -> (obs, reward,
done)`` over leading batch dimensions; the state layout is
[q(ndof), qd(ndof), extra...] (extra = non-dynamic state, passed through).
"""

from __future__ import annotations

import torch

from icem_torch.envs.base import Env
from icem_torch.ops.spatial_rollout import rollout_spatial


class SpatialEnv(Env):
    """Env whose dynamics live on the spatial 3D engine."""

    def _post_step(self, state, new_state, action):
        """(obs, reward, done) from the transition; action arrives clipped."""
        raise NotImplementedError

    def _physics(self, states, actions):
        """[P, S] states under clipped [P, h, A] actions -> (qs, qds) [h, P, nd]."""
        if self.action_repeat != 1:
            raise NotImplementedError(
                f"action_repeat={self.action_repeat} is not ported to icem_torch yet")
        nd = self.model.ndof
        return rollout_spatial(self.model, states[:, :nd], states[:, nd: 2 * nd],
                               actions.contiguous())

    def step(self, state, action):
        new_states, obs, rewards, dones = self.step_batched(state[None], action[None])
        return new_states[0], obs[0], rewards[0], dones[0]

    def step_batched(self, states, actions):
        """Population step: (states [P,S], actions [P,A]) ->
        (new_states, obs, rewards, dones)."""
        nd = self.model.ndof
        acts = torch.clamp(actions, -1.0, 1.0)
        qs, qds = self._physics(states, acts[:, None, :])
        new_states = torch.cat([qs[0], qds[0], states[:, 2 * nd:]], dim=1)
        obs, rewards, dones = self._post_step(states, new_states, acts)
        return new_states, obs, rewards, dones

    def rollout_batched(self, states, actions):
        """Full open-loop rollout: one kernel launch for the whole horizon.

        states: [P, S]; actions: [P, h, A]. Returns the rollout_open_loop
        contract: (obs_seq, next_obs_seq, actions_tm, rewards, final_states)
        with time-major [h, P, ...] sequences.
        """
        acts = torch.clamp(actions, -1.0, 1.0)
        qs, qds = self._physics(states, acts)
        return self._assemble_rollout(states, acts, qs, qds)

    def _assemble_rollout(self, states, acts, qs, qds):
        """qs, qds [h, P, nd] -> the rollout_open_loop output contract."""
        h = qs.shape[0]
        nd = self.model.ndof
        extra = states[:, 2 * nd:]
        extra_seq = extra[None].expand((h,) + extra.shape)
        next_states = torch.cat([qs, qds, extra_seq], dim=2)
        prev_states = torch.cat([states[None], next_states[:-1]], dim=0)
        final_states = next_states[-1]

        acts_tm = acts.transpose(0, 1)  # [h, P, A]
        next_obs_seq, rewards, _ = self._post_step(prev_states, next_states, acts_tm)
        obs_seq = self.observation(prev_states)
        return obs_seq, next_obs_seq, acts_tm, rewards, final_states
