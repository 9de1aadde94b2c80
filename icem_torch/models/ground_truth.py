"""Ground-truth forward models backed by the env dynamics.

Counterpart of ``icem_tpu/models/ground_truth.py``: the model state is the
env state tensor, one-step prediction is ``env.step_batched`` (the repeated
step where the env repeats its actions), and a whole open-loop rollout is
``env.rollout_batched`` (one kernel launch for the planar and spatial envs),
where the env has one and does not decline. ``ParallelGroundTruthModel`` is an alias so configs that name it
resolve unchanged; its ``num_parallel`` is accepted and unused.
"""

from __future__ import annotations

from icem_torch.models.base import ForwardModel


class GroundTruthModel(ForwardModel):
    """Forward model that IS the environment dynamics."""

    def __init__(self, *, env, **kwargs):
        super().__init__(env=env)

        def _predict(model_states, obs, actions):
            next_states, next_obs, rewards, _ = env.step_batched(model_states, actions)
            return next_states, next_obs, rewards

        if hasattr(env, "rollout_batched"):
            _predict.rollout = env.rollout_batched
        self.predict_fn = _predict

    def init_model_state(self, observation, env_state=None):
        """The real env state when given, else one rebuilt from the observation."""
        if env_state is not None:
            return env_state
        return self.env.state_from_observation(observation)


class ParallelGroundTruthModel(GroundTruthModel):
    """Config-compatible alias of GroundTruthModel."""

    def __init__(self, *, env, num_parallel: int = 0, **kwargs):
        super().__init__(env=env)
        self.num_parallel = num_parallel  # accepted for config parity; unused
