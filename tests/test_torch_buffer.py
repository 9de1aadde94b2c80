"""icem_torch's rollout buffer against the JAX package's: the same numpy
episodes give the same flat views, stacks, splits and reward statistics,
and the same ``compute_reward_info``."""

import numpy as np
import pytest

from icem_torch.runtime import buffer as tbuf
from icem_torch.runtime.rollout import compute_reward_info as t_reward_info
from icem_tpu.runtime import buffer as jbuf
from icem_tpu.runtime.rollout import compute_reward_info as j_reward_info


def _episodes(seed, lengths, success=False):
    rng = np.random.default_rng(seed)
    out = []
    for t in lengths:
        data = dict(observations=rng.standard_normal((t, 5)).astype(np.float32),
                    next_observations=rng.standard_normal((t, 5)).astype(np.float32),
                    actions=rng.uniform(-1, 1, (t, 2)).astype(np.float32),
                    rewards=rng.standard_normal(t).astype(np.float32),
                    dones=np.zeros(t, np.float32))
        if success:
            data["successes"] = (rng.uniform(size=t) > 0.5).astype(np.float32)
        out.append(data)
    return out


def _both(episodes, max_size=None):
    return (tbuf.RolloutBuffer([tbuf.Rollout(data=e) for e in episodes], max_size=max_size),
            jbuf.RolloutBuffer([jbuf.Rollout(data=e) for e in episodes], max_size=max_size))


@pytest.mark.parametrize("lengths", [(6, 6, 6), (4, 0, 7)], ids=["equal", "ragged"])
def test_buffer_matches_jax(lengths):
    port, ref = _both(_episodes(0, lengths))
    assert len(port) == len(ref) == len(lengths)
    assert sorted(port.flat) == sorted(ref.flat)
    for k in ref.flat:
        np.testing.assert_array_equal(port.flat[k], ref.flat[k])
        np.testing.assert_array_equal(port[k], ref[k])
    for name in ("mean_avg_reward", "mean_max_reward", "mean_return", "std_return"):
        assert getattr(port, name) == getattr(ref, name), name
    if len(set(lengths)) == 1:
        np.testing.assert_array_equal(port.as_array("actions"), ref.as_array("actions"))
    for a, b in zip(port.split(0.5, key=3), ref.split(0.5, key=3)):
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.flat["rewards"], b.flat["rewards"])
    r_port, r_ref = port[0], ref[0]
    np.testing.assert_array_equal(r_port.cost_to_go(), r_ref.cost_to_go())
    assert r_port.cost_to_go(1, discount=0.9) == r_ref.cost_to_go(1, discount=0.9)


def test_fifo_eviction_matches_jax():
    port, ref = _both(_episodes(1, (3, 4, 5, 6)), max_size=10)
    assert [len(r) for r in port] == [len(r) for r in ref] == [6]


@pytest.mark.parametrize("success", [False, True])
def test_reward_info_matches_jax(success):
    port, ref = _both(_episodes(2, (5, 3, 5), success=success))
    got = t_reward_info(port, prefix="train_", exec_time=1.5)
    want = j_reward_info(ref, prefix="train_", exec_time=1.5)
    assert got == want
    assert ("train_mean_success" in got) == success


def test_unknown_field_is_refused():
    with pytest.raises(ValueError, match="unknown rollout fields"):
        tbuf.Rollout(data=dict(observations=np.zeros((1, 2)), bogus=np.zeros(1)))
