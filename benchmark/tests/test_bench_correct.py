"""The comparison that decides ``correct``: a sound run passes, the control
and each fault a cell can have do not.

On the CPU the program runs its plain versions, which the frozen reference
copies to the bit, so a sound run reads 0 on every gap; the runs here drive
a whole cell (set-up, warm-up, window, check) at a tiny size, with the
timed path broken underneath where a test plants a fault. The card test
runs one episode of the first cell at its own size."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import TINY

# the standup's scanned loop at a size where it masks rows: 16 / 8 / 8 of
# 16 valid, one elite kept
STANDUP_TINY = {"controller_params.num_simulated_trajectories": 16,
                "controller_params.factor_decrease_num": 2.0,
                "controller_params.horizon": 2,
                "controller_params.action_sampler_params.elites_size": 4,
                "rollout_params.task_horizon": 4}

SEED = 2**31 + 77


def _run(cell="cheetah_blitz.episodes", **kw):
    return harness.run_cell(cell, SEED, 0.0, False, kw.pop("device", "cpu"),
                            overrides=kw.pop("overrides", TINY), log=lambda m: None, **kw)


def _fails(numbers: dict, cell: str) -> list:
    lim = harness.limits(cell)
    return [n for n, v in numbers.items() if v > lim[n]["limit"]]


@pytest.mark.parametrize("cell", ["cheetah_blitz.episodes", "cheetah_blitz.host_loop"])
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    r = _run(cell, control=True)
    assert r["correct"] is True, r["checks"]
    assert all(v == 0.0 for v in r["_numbers"].values())
    assert _fails(r["_control"], cell)


def test_a_sound_standup_run_is_correct():
    r = _run("standup_blitz.episodes", overrides=STANDUP_TINY, control=True)
    assert r["correct"] is True, r["checks"]
    assert all(v == 0.0 for v in r["_numbers"].values())
    assert _fails(r["_control"], "standup_blitz.episodes")


def _env_classes():
    from icem_torch.envs.planar_base import PlanarEnv
    from icem_torch.envs.spatial_base import SpatialEnv

    return PlanarEnv, SpatialEnv


def _state_unchanged(monkeypatch):
    for cls in _env_classes():
        step = cls.step

        def frozen(self, state, action, step=step):
            _, _, reward, done = step(self, state, action)
            return state, self.observation(state), reward, done

        monkeypatch.setattr(cls, "step", frozen)


def _half_population(monkeypatch):
    for cls in _env_classes():
        rollout = cls.rollout_batched

        def half(self, states, actions, rollout=rollout):
            P = actions.shape[0]
            k = (P + 1) // 2
            obs, nxt, acts, rew, final = rollout(self, states[:k], actions[:k])
            idx = torch.arange(P) % k
            return obs[:, idx], nxt[:, idx], acts[:, idx], rew[:, idx], final[idx]

        monkeypatch.setattr(cls, "rollout_batched", half)


def _action_altered(monkeypatch):
    from icem_torch.controllers import icem

    plan_step = icem.plan_step

    def altered(*args, **kwargs):
        res = plan_step(*args, **kwargs)
        return res._replace(action=res.action + 0.01)

    monkeypatch.setattr(icem, "plan_step", altered)


def _masks_ignored(monkeypatch):
    """The scanned loop counts its decayed rows as candidates: every
    iteration ranks all of the first iteration's population."""
    import dataclasses

    from icem_torch.controllers import icem

    scan = icem._plan_step_scan

    def unmasked(cfg, *args, **kwargs):
        return scan(dataclasses.replace(cfg, factor_decrease_num=1.0), *args, **kwargs)

    monkeypatch.setattr(icem, "_plan_step_scan", unmasked)


@pytest.mark.parametrize("cell", ["cheetah_blitz.episodes", "cheetah_blitz.host_loop"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_population, _action_altered])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_population, _action_altered,
                                   _masks_ignored])
def test_a_fault_in_the_standups_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run("standup_blitz.episodes", overrides=STANDUP_TINY)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
def test_one_episode_on_the_card_is_correct_and_its_control_is_not(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    r = harness.run_cell("cheetah_blitz.episodes", SEED, 0.0, False, cuda_device,
                         control=True, log=lambda m: None)
    assert r["correct"] is True, r["checks"]
    assert _fails(r["_control"], "cheetah_blitz.episodes")
