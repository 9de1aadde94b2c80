"""icem_torch's episode runtime: the host path and the device-resident path
truncate a physics blow-up identically, chunked device episodes equal whole
ones to the bit, and both paths give the JAX package's arrays on the same toy
env. The port of ``tests/test_rollout_containment.py``.

The env's observation (and reward) go NaN on a fixed step, so both paths
face the same event: the blown transition itself is invalid (the host path
breaks before appending it), its NaN reward is zeroed, and every later step
of the device path is frozen at the last finite state.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_torch.envs.base import BoxSpace, Env
from icem_torch.runtime.rollout import RolloutManager
from icem_torch.runtime.seeding import Seeding
from icem_tpu.envs.base import BoxSpace as JaxBoxSpace
from icem_tpu.envs.base import Env as JaxEnv
from icem_tpu.runtime.rollout import RolloutManager as JaxRolloutManager
from icem_tpu.runtime.seeding import Seeding as JaxSeeding

FIELDS = ("observations", "next_observations", "actions", "rewards", "dones")


class ExplodingEnv(Env):
    """1-D integrator, state [t, x], whose observation and reward go NaN on
    the step that moves t to ``blow_at``."""

    name = "exploding"

    def __init__(self, blow_at: int = 4, **kwargs):
        self.observation_space = BoxSpace(np.full(1, -np.inf), np.full(1, np.inf))
        self.action_space = BoxSpace(np.full(1, -1.0), np.full(1, 1.0))
        super().__init__(**kwargs)
        self.blow_at = int(blow_at)

    def init_state(self, generator, mode: str = "train"):
        return torch.zeros(2, device=generator.device)

    def observation(self, state):
        return state[..., 1:2]

    def step(self, state, action):
        t, x = state[0], state[1]
        bad = t + 1.0 >= self.blow_at
        x2 = torch.where(bad, float("nan"), x + 0.1 * action[0])
        next_state = torch.stack([t + 1.0, x2])
        reward = torch.where(bad, float("nan"), 1.0)
        return next_state, self.observation(next_state), reward, torch.zeros(())

    def cost_fn(self, observation, action, next_obs):
        return torch.sum(next_obs**2, dim=-1)


class JaxExplodingEnv(JaxEnv):
    """The same env in the JAX package (tests/test_rollout_containment.py)."""

    name = "exploding"

    def __init__(self, blow_at: int = 4, **kwargs):
        self.observation_space = JaxBoxSpace(np.full(1, -np.inf), np.full(1, np.inf))
        self.action_space = JaxBoxSpace(np.full(1, -1.0), np.full(1, 1.0))
        super().__init__(**kwargs)
        self.blow_at = int(blow_at)

    def init_state(self, key, mode: str = "train"):
        return jnp.zeros(2, jnp.float32)

    def observation(self, state):
        return state[..., 1:2]

    def step(self, state, action):
        t, x = state[0], state[1]
        bad = t + 1.0 >= self.blow_at
        x2 = jnp.where(bad, jnp.nan, x + 0.1 * action[0])
        next_state = jnp.stack([t + 1.0, x2])
        reward = jnp.where(bad, jnp.nan, 1.0)
        return next_state, self.observation(next_state), reward, jnp.float32(0.0)

    def cost_fn(self, observation, action, next_obs):
        return jnp.sum(next_obs**2, axis=-1)


class ZeroPolicy:
    """A functional controller with a constant action, for both paths and
    both packages."""

    def __init__(self, value: float = 0.0, jax: bool = False):
        self.value, self.jax = value, jax

    def functional_plan(self):
        if self.jax:
            return lambda ps, ob, env_state, model_params: (jnp.full(1, self.value), ps)
        return lambda ps, ob, env_state, model_params=None: (
            torch.full((1,), self.value, device=ob.device), ps)

    def init_plan_state(self, obs_dim, generator):
        return jnp.zeros(()) if self.jax else torch.zeros(())

    def get_action(self, obs, state, mode="train"):
        return np.full(1, self.value, np.float32)


class HostOnly:
    """A policy without the functional interface: the host path."""

    def get_action(self, obs, state, mode="train"):
        return np.zeros(1, np.float32)


def _manager(env, **params):
    return RolloutManager(env, {"task_horizon": 10, **params}, device="cpu")


def _run_both_paths(blow_at, horizon=10):
    Seeding.set_seed(0)
    env = ExplodingEnv(blow_at=blow_at)
    host = _manager(env, task_horizon=horizon, fuse_on_device=False)
    device = _manager(env, task_horizon=horizon, fuse_on_device=True)
    return host.sample(ZeroPolicy(), no_rollouts=1)[0], device.sample(ZeroPolicy())[0]


def test_blowup_truncates_identically_on_both_paths():
    r_host, r_device = _run_both_paths(blow_at=4)
    assert len(r_host) == 3 and len(r_device) == 3
    for key in FIELDS:
        np.testing.assert_allclose(r_device[key], r_host[key], atol=1e-6, err_msg=key)
        assert np.all(np.isfinite(r_device[key])), key


def test_blowup_on_first_step_yields_empty_rollout_both_paths():
    r_host, r_device = _run_both_paths(blow_at=1)
    assert len(r_host) == 0 and len(r_device) == 0


def test_device_return_is_finite_even_with_nan_reward():
    _, r_device = _run_both_paths(blow_at=4)
    total = float(np.sum(r_device["rewards"]))
    assert np.isfinite(total) and total == 3.0


@pytest.mark.parametrize("blow_at", [4, 99], ids=["truncated", "whole"])
def test_chunked_device_episodes_match_unchunked_bitwise(blow_at):
    """11 steps in chunks of 4: the blow-up lands mid-chunk, or never."""
    results = []
    for chunk in (None, 4):
        Seeding.set_seed(0)
        rm = _manager(ExplodingEnv(blow_at=blow_at), task_horizon=11, fuse_on_device=True)
        results.append(rm.sample_on_device(ZeroPolicy(0.5), no_rollouts=3, chunk=chunk))
    for rw, rc in zip(*results):
        assert len(rw) == len(rc) == (3 if blow_at == 4 else 11)
        for key in FIELDS:
            np.testing.assert_array_equal(rw[key], rc[key], err_msg=key)


def test_auto_chunk_triggers_above_fused_step_limit(monkeypatch):
    """fuse_on_device='auto' chunks (does not leave the device) when the call
    asks for more steps than the env's limit, with the same rollouts."""

    class BudgetedEnv(ExplodingEnv):
        fused_episode_step_limit = 10  # 2 episodes x 9 steps = 18 > 10

    Seeding.set_seed(0)
    rm = _manager(BudgetedEnv(blow_at=99), task_horizon=9, fuse_on_device="auto")
    chunks = []
    real = rm.sample_on_device
    monkeypatch.setattr(rm, "sample_on_device",
                        lambda policy, chunk=None, **kw: chunks.append(chunk)
                        or real(policy, chunk=chunk, **kw))
    rollouts = rm.sample(ZeroPolicy(0.5), no_rollouts=2)
    assert chunks == [5]  # ceil(9 / ceil(18 / 10)) = 5-step chunks
    assert rm.sample(ZeroPolicy(0.5), no_rollouts=1) and chunks == [5, None]
    Seeding.set_seed(0)
    ref = _manager(BudgetedEnv(blow_at=99), task_horizon=9, fuse_on_device=True)
    for rw, rc in zip(ref.sample(ZeroPolicy(0.5), no_rollouts=2), rollouts):
        assert len(rw) == len(rc) == 9
        np.testing.assert_array_equal(rw["observations"], rc["observations"])


def test_device_episodes_are_independent_and_follow_their_streams():
    """A blown episode does not poison the next one of the call; each
    episode's start comes from its own stream, and a new epoch gives new
    streams."""

    class MixedEnv(ExplodingEnv):
        # episodes whose stream draws x0 > 0 blow at step 2, others never
        def init_state(self, generator, mode="train"):
            x0 = torch.rand((), generator=generator) * 2.0 - 1.0
            return torch.stack([torch.where(x0 > 0, 0.0, -1e6), x0])

    def starts(epoch):
        Seeding.set_seed(0)
        rm = _manager(MixedEnv(blow_at=2), task_horizon=6, fuse_on_device=True)
        rm.set_epoch(epoch)
        rollouts = rm.sample(ZeroPolicy(), no_rollouts=8)
        for r in rollouts:
            assert np.all(np.isfinite(r["rewards"]))
        assert {len(r) for r in rollouts} == {1, 6}  # both kinds occurred
        return [float(r["observations"][0, 0]) for r in rollouts]

    assert starts(0) == starts(0)
    assert starts(0) != starts(1)


@pytest.mark.parametrize("fuse", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("blow_at", [4, 99], ids=["truncated", "whole"])
def test_rollouts_match_jax(fuse, blow_at):
    """The same toy env and constant policy through both packages'
    RolloutManager: identical arrays, dtypes included."""
    params = {"task_horizon": 6, "fuse_on_device": fuse}
    Seeding.set_seed(0)
    port = RolloutManager(ExplodingEnv(blow_at=blow_at), params, device="cpu").sample(
        ZeroPolicy(0.5), no_rollouts=2)
    JaxSeeding.set_seed(0)
    ref = JaxRolloutManager(JaxExplodingEnv(blow_at=blow_at), params).sample(
        ZeroPolicy(0.5, jax=True), no_rollouts=2)
    for rp, rr in zip(port, ref):
        assert len(rp) == len(rr) == (3 if blow_at == 4 else 6)
        assert sorted(rp.field_names) == sorted(rr.field_names)
        for key in FIELDS:
            np.testing.assert_array_equal(rp[key], np.asarray(rr[key]), err_msg=key)
            assert rp[key].dtype == np.asarray(rr[key]).dtype, key


def test_done_ends_the_episode_identically_on_both_paths():
    """An env's done flag ends the episode after its own transition on the
    host path (break); the device path keeps that transition, zeroes the
    rewards of every later step and freezes the state."""

    class DoneEnv(ExplodingEnv):
        def step(self, state, action):
            next_state, obs, reward, _ = super().step(state, action)
            return next_state, obs, reward, (next_state[0] >= 3.0).to(torch.float32)

    r_host, r_device = (
        _manager(DoneEnv(blow_at=99), task_horizon=8, fuse_on_device=fuse).sample(
            ZeroPolicy(0.5))[0] for fuse in (False, True))
    assert len(r_host) == len(r_device) == 3
    np.testing.assert_array_equal(r_device["dones"], [0.0, 0.0, 1.0])
    for key in FIELDS:
        np.testing.assert_allclose(r_device[key], r_host[key], atol=1e-6, err_msg=key)


def test_only_final_reward_on_both_paths():
    for fuse in (False, True):
        Seeding.set_seed(0)
        rm = _manager(ExplodingEnv(blow_at=99), task_horizon=5, fuse_on_device=fuse,
                      only_final_reward=True)
        r = rm.sample(ZeroPolicy())[0]
        np.testing.assert_array_equal(r["rewards"], [0.0, 0.0, 0.0, 0.0, 1.0])


def test_host_path_serves_a_policy_without_functional_plan():
    Seeding.set_seed(0)
    rm = _manager(ExplodingEnv(blow_at=4), fuse_on_device=True)
    r = rm.sample(HostOnly(), no_rollouts=1)[0]
    assert len(r) == 3 and r["rewards"].dtype == np.float64


def test_render_and_record_are_not_ported(tmp_path):
    # both are ported (tests/test_torch_video.py writes the videos): record
    # is off when falsy, "videos" when True, a directory when a string, and
    # an episode that records or renders takes the host loop, even for a
    # policy with the functional interface (the host loop's rewards are
    # float64). An env without a model draws no frame and writes no file.
    assert _manager(ExplodingEnv(), record=True).record == "videos"
    assert _manager(ExplodingEnv(), record=False).record == ""
    out = tmp_path / "videos"
    rm = _manager(ExplodingEnv(blow_at=99), task_horizon=3, record=str(out))
    assert rm.record == str(out)
    r = rm.sample(ZeroPolicy())[0]
    assert len(r) == 3 and r["rewards"].dtype == np.float64
    assert os.listdir(out) == []
    r = _manager(ExplodingEnv(blow_at=99), task_horizon=3).sample(ZeroPolicy(), render=True)[0]
    assert len(r) == 3 and r["rewards"].dtype == np.float64
