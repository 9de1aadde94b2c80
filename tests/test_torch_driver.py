"""icem_torch's experiment driver (``icem_torch.main``) on the CPU, at a tiny
size: the shipped settings run with overrides, write metrics, settings and
checkpoints, resume where they stopped, and a saved controller's next action
is reproduced to the bit. The port of ``tests/test_driver.py`` and
``tests/test_controllers.py::test_controller_save_load_resume_fidelity``.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icem_torch import main as tmain
from icem_torch.controllers import controller_from_string
from icem_torch.envs import env_from_string
from icem_torch.models import forward_model_from_string
from icem_torch.runtime.checkpoint import pack_pytree, unpack_pytree
from icem_torch.runtime.config import apply_overrides, resolve_settings
from icem_torch.runtime.rollout import RolloutManager
from icem_torch.runtime.seeding import Seeding
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {"halfcheetah": ROOT / "settings" / "halfcheetah_running" / "i-cem-blitz.json",
            "ant": ROOT / "settings" / "ant" / "i-cem-blitz.json"}
TINY = ["controller_params.num_simulated_trajectories=8", "controller_params.horizon=4",
        "rollout_params.task_horizon=3", "training_iterations=2", "seed=3"]
METRICS = ("train_mean_avg_reward", "train_mean_max_reward", "train_mean_return",
           "train_std_return", "train_exec_time")


def _params(env, model_dir, *extra):
    return apply_overrides(resolve_settings(str(SETTINGS[env])),
                           TINY + [f"model_dir={model_dir}", *extra])


@pytest.mark.parametrize("env", ["halfcheetah", "ant"])
def test_run_writes_metrics_settings_checkpoints_and_resumes(env, tmp_path):
    md = str(tmp_path / env)
    if env == "halfcheetah":  # the command line, as a user runs it
        info = tmain.main(["main", str(SETTINGS[env]), *TINY, f"model_dir={md}",
                           "--device", "cpu"])
    else:
        info = tmain.run(_params(env, md), device="cpu")
    assert info["step"] == [0, 1]
    for key in METRICS:
        assert len(info[key]) == 2 and all(np.isfinite(info[key])), key
    logged = [json.loads(line) for line in open(os.path.join(md, "metrics.jsonl"))]
    assert {e["key"] for e in logged} == set(METRICS)
    saved = json.load(open(os.path.join(md, "settings.json")))
    assert saved == json.loads(json.dumps(_params(env, md), sort_keys=True))
    assert "device" not in saved
    latest = os.path.join(md, "checkpoints_latest")
    assert os.path.islink(latest) and os.readlink(latest) == "checkpoints_001"
    assert sorted(os.listdir(latest)) == ["controller", "main_state.npz", "reward_info.npy",
                                          "rollout_buffer.pkl"]

    # resume: load "auto" continues at iteration 2 with the history restored
    resumed = tmain.run(_params(env, md, "training_iterations=3", "checkpoints.load=auto"),
                        device="cpu")
    assert resumed["step"] == [0, 1, 2]
    for key in METRICS:
        assert resumed[key][:2] == info[key], key
    assert os.readlink(latest) == "checkpoints_002"


@pytest.mark.parametrize("env", ["halfcheetah", "ant"])
def test_controller_save_load_gives_the_same_next_action(env, tmp_path):
    """A mid-episode checkpoint restores the planner exactly: distribution,
    elite memory and the generator's state (the unrolled loop on
    HalfCheetah, the scanned one on Ant)."""
    params = _params(env, tmp_path, "controller_params.seed=21")
    Seeding.set_seed(0)

    def build():
        e = env_from_string(params.env, **params.env_params)
        model = forward_model_from_string(params.forward_model)(
            env=e, **params.forward_model_params)
        return e, tmain.get_controllers(params, e, model, device="cpu")[1]

    e, ctrl = build()
    state = e.init_state(Seeding.generator_for("start", "cpu"))
    obs = e.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(3):  # mid-episode: elite memory and shifted mean are live
        ctrl.get_action(obs, state)
    path = str(tmp_path / "controller")
    ctrl.save(path)
    a_orig = ctrl.get_action(obs, state)

    restored = build()[1]
    restored.load(path)
    assert restored._pstate.have_elites
    np.testing.assert_array_equal(a_orig, restored.get_action(obs, state))

    # a checkpoint of another planner shape leaves a fresh planner alone
    other = apply_overrides(params, ["controller_params.horizon=5"])
    fresh = tmain.get_controllers(other, e, restored.forward_model, device="cpu")[1]
    fresh.load(path)
    assert fresh._pstate is None


def test_packed_generator_restores_only_on_its_device_type():
    gen = torch.Generator().manual_seed(5)
    tree = {"g": gen, "x": torch.arange(3.0), "n": (True, None)}
    packed = pack_pytree(tree)
    assert isinstance(packed["x"], np.ndarray) and packed["n"] == (True, None)
    back = unpack_pytree(packed, "cpu")
    assert torch.equal(torch.rand(4, generator=back["g"]), torch.rand(4, generator=gen))
    with pytest.raises(ValueError, match="cpu generator state"):
        unpack_pytree(packed, "cuda")


def test_unported_names_and_options_raise(tmp_path):
    # every controller string resolves since the other controllers were
    # ported (tests/test_torch_controllers.py), and both learned models
    # since they were (tests/test_torch_ensemble.py, tests/test_torch_rssm.py)
    for name, cls in (("EnsembleModel", "EnsembleModel"), ("RSSM", "RSSMModel")):
        assert forward_model_from_string(name).__name__ == cls
    with pytest.raises(ImportError, match="GroundTruthModel"):
        forward_model_from_string("NoSuchModel")
    # recording and rendering are ported: one video per episode, one frame a
    # step, named <name>_<episode counter> (tests/test_torch_video.py)
    videos = tmp_path / "videos"
    info = tmain.run(_params("halfcheetah", tmp_path / "rec",
                             f"rollout_params.record={videos}"), device="cpu")
    assert info["step"] == [0, 1]
    assert sorted(os.listdir(videos)) == ["live_frame.png", "train_0001.avi", "train_0001.gif",
                                          "train_0002.avi", "train_0002.gif"]
    info = tmain.run(_params("halfcheetah", tmp_path / "ren", "rollout_params.render=true"),
                     device="cpu")
    assert info["step"] == [0, 1] and all(np.isfinite(info["train_mean_return"]))


def test_run_without_a_device_raises_where_there_is_no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.run(_params("halfcheetah", tmp_path / "none"))
    assert not (tmp_path / "none").exists()


def test_metrics_logger_writes_jsonl_timers_and_a_device_trace(tmp_path):
    from icem_torch.runtime.metrics import MetricsLogger

    logger = MetricsLogger(str(tmp_path), use_tensorboard=False)
    logger.log(1.5, key="a")
    logger.log(2.5, key="a")
    with logger.phase_timer("plan", step=7):
        pass
    with logger.device_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    logger.close()
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [(e["key"], e["value"], e["step"]) for e in lines[:2]] == [("a", 1.5, 0), ("a", 2.5, 1)]
    assert lines[2]["key"] == "plan_time" and lines[2]["step"] == 7
    assert logger.step_per_key == {"a": 2}
    assert json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]


def test_set_seed_seeds_numpy_and_the_env():
    seen = []

    class Env:
        def seed(self, seed):
            seen.append(seed)

    assert Seeding.set_seed(11, env=Env()) == 11 and seen == [11]
    first = np.random.rand(3)
    Seeding.set_seed(11)
    np.testing.assert_array_equal(np.random.rand(3), first)
    env = env_from_string("HalfCheetah")
    assert env.get_fps() == 20.0 and env.seed(3) == 3 and env.close() is None
    state, obs = env.reset_with_mode(Seeding.generator_for("reset", "cpu"), "train")
    assert tuple(state.shape) == (18,) and torch.equal(obs, env.observation(state))
    assert env.is_success(obs, torch.zeros(6), obs) is None


class _OpenLoop:
    """A fixed action sequence, through the device path's functional
    interface; the plan state is the step index."""

    def __init__(self, actions):
        self.actions = actions

    def functional_plan(self):
        return lambda t, obs, env_state, model_params=None: (self.actions[t], t + 1)

    def init_plan_state(self, obs_dim, generator):
        return 0


def test_device_episode_matches_jax_rollout():
    """The slice as a whole on HalfCheetah: a device-path episode under a
    fixed action sequence against the JAX package's rollout of the same
    start state and actions (its row engine, padded to a population it
    batches). Planner decisions are not compared: the PRNG streams differ.
    Both run the row engine in float32: the gap is about 3e-5 over these 5
    steps, held at 2e-4."""
    h = 5
    kw = dict(exclude_current_positions_from_observation=False, penalise_flipping=True)
    env = env_from_string("HalfCheetah", **kw)
    A = np.random.default_rng(7).uniform(-1, 1, (h, 6)).astype(np.float32)
    Seeding.set_seed(4)
    rm = RolloutManager(env, {"task_horizon": h, "fuse_on_device": True}, device="cpu")
    r = rm.sample(_OpenLoop(torch.from_numpy(A)))[0]
    assert len(r) == h
    np.testing.assert_array_equal(r["actions"], A)

    s0 = r["observations"][0]  # positions included: the observation is the state
    P = 64
    _, next_obs, _, rewards, _ = jax.jit(JaxCheetah(**kw).rollout_batched)(
        jnp.broadcast_to(jnp.asarray(s0), (P, 18)), jnp.broadcast_to(jnp.asarray(A), (P, h, 6)))
    np.testing.assert_allclose(r["next_observations"], np.asarray(next_obs[:, 0]), atol=2e-4)
    np.testing.assert_allclose(r["rewards"], np.asarray(rewards[:, 0]), atol=2e-4)
    np.testing.assert_array_equal(r["observations"][1:], r["next_observations"][:-1])


# the shipped settings of the planar and analytic envs, at a tiny size
SHIPPED = {
    "hopper": "hopper/i-cem-blitz.json",                      # terminating, B1 <6, 4, 3, 3>
    "pendulum": "pendulum/i-cem-blitz.json",                  # analytic
    "mountain_car": "mountain_car/i-cem-best.json",           # analytic, "best" cost
    "cartpole_swingup_gt": "planet/cartpole_swingup_gt.json",  # action repeat 8, scanned loop
}


@pytest.mark.parametrize("name", list(SHIPPED))
def test_shipped_planar_and_analytic_settings_run_on_the_cpu(name, tmp_path):
    md = str(tmp_path / name)
    params = apply_overrides(resolve_settings(str(ROOT / "settings" / SHIPPED[name])), TINY + [
        "controller_params.action_sampler_params.elites_size=3",
        "controller_params.action_sampler_params.opt_iterations=2", f"model_dir={md}"])
    info = tmain.run(params, device="cpu")
    assert info["step"] == [0, 1]
    for key in METRICS:
        assert len(info[key]) == 2 and all(np.isfinite(info[key])), key
    latest = os.path.join(md, "checkpoints_latest")
    assert os.path.islink(latest) and os.readlink(latest) == "checkpoints_001"
    env = env_from_string(params.env, **params.env_params)
    if name == "cartpole_swingup_gt":
        assert env.action_repeat == 8 and env.get_fps() == pytest.approx(12.5)
    if name == "hopper":
        assert env.model.ndof == 6 and env.obs_dim == 12


# the shipped settings of the other controllers and the goal-conditioned envs
OTHER = {
    "cem_std": ("halfcheetah_running/cem-std.json", []),            # vanilla CEM, B1's path
    "fetch_reach": ("fetch_reach/i-cem-blitz.json", []),            # goal env, success
    "door": ("door/i-cem-blitz.json", ["controller_params.action_sampler_params.elites_size=3",
                                       "controller_params.action_sampler_params.opt_iterations=2"]),
    # a random initial phase in front of the main controller
    "random_initial": ("halfcheetah_running/i-cem-blitz.json",
                       ["initial_controller=random", "initial_number_of_rollouts=1"]),
}


@pytest.mark.parametrize("name", list(OTHER))
def test_shipped_goal_env_and_controller_settings_run_on_the_cpu(name, tmp_path):
    md = str(tmp_path / name)
    path, extra = OTHER[name]
    params = apply_overrides(resolve_settings(str(ROOT / "settings" / path)),
                             TINY + extra + [f"model_dir={md}"])
    info = tmain.run(params, device="cpu")
    steps = [0, 1, 2] if name == "random_initial" else [0, 1]
    assert info["step"] == steps
    metrics = METRICS + (("train_mean_success", "train_std_success")
                         if name in ("fetch_reach", "door") else ())
    for key in metrics:
        assert len(info[key]) == len(steps) and all(np.isfinite(info[key])), key
    logged = {json.loads(line)["key"] for line in open(os.path.join(md, "metrics.jsonl"))}
    assert set(metrics) <= logged
    assert os.readlink(os.path.join(md, "checkpoints_latest")) == f"checkpoints_00{steps[-1]}"
    main_cls = {"cem_std": "MpcCemStd"}.get(name, "MpcICem")
    assert controller_from_string(params.controller).__name__ == main_cls
    if name == "random_initial":
        # the random phase's episode differs from the planner's
        assert info["train_mean_return"][0] != info["train_mean_return"][1]


def test_fpp_settings_resolve_with_their_rollout_key(tmp_path):
    """settings/fpp carries rollout_params.num_parallel, which the JAX
    driver reads and does not use either; a run goes through."""
    md = str(tmp_path / "fpp")
    params = apply_overrides(resolve_settings(str(ROOT / "settings" / "fpp" / "i-cem-blitz.json")),
                             TINY + ["training_iterations=1", f"model_dir={md}"])
    assert params.rollout_params.num_parallel == 16
    info = tmain.run(params, device="cpu")
    assert info["step"] == [0] and np.isfinite(info["train_mean_success"][0])


def _controller(name, params_path, seed):
    params = apply_overrides(resolve_settings(str(ROOT / "settings" / params_path)),
                             TINY + [f"controller_params.seed={seed}"])
    env = env_from_string(params.env, **params.env_params)
    model = forward_model_from_string(params.forward_model)(env=env)
    cls = controller_from_string(name)
    kwargs = dict(params.controller_params) if name != "random" else dict(
        action_change_frequency=3, seed=seed)
    if name == "mpc-random":
        kwargs = dict(horizon=4, num_simulated_trajectories=8, seed=seed)
    return env, tmain._build_controller(cls, env, model, kwargs, "cpu")


@pytest.mark.parametrize("name", ["mpc-cem-std", "random", "mpc-random"])
def test_other_controllers_save_load_gives_the_same_next_actions(name, tmp_path):
    """A controller saved mid-episode and loaded into a fresh one of another
    seed gives the same next actions to the bit: the CEM distribution and
    generator, the random policy's held action and generator, the random
    shooter's generator."""
    path = "halfcheetah_running/cem-std.json" if name == "mpc-cem-std" else \
        "halfcheetah_running/i-cem-blitz.json"
    Seeding.set_seed(0)
    env, ctrl = _controller(name, path, seed=21)
    state = env.init_state(Seeding.generator_for("start", "cpu"))
    obs = env.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(2):  # mid-episode (mid-hold for the random policy)
        ctrl.get_action(obs, state)
    ctrl.save(str(tmp_path / "controller"))
    a_orig = [ctrl.get_action(obs, state) for _ in range(3)]

    restored = _controller(name, path, seed=99)[1]
    restored.beginning_of_rollout(observation=obs, state=state)
    restored.load(str(tmp_path / "controller"))
    for a in a_orig:
        np.testing.assert_array_equal(a, restored.get_action(obs, state))
    restored.load(str(tmp_path / "missing"))  # no checkpoint: nothing changes
