"""icem_torch's rendering and video writers (``envs/physics/render.py``,
``runtime/video.py``) against the JAX package's frames and the image
library's decoders, and the episodes and plan replays that use them.

The port draws the JAX package's matplotlib scene in numpy and writes its
files with its own JPEG, GIF and PNG encoders; here PIL decodes them. Frames
are held to the JAX frames' shape and dtype, the host forward kinematics to
1e-12, and the drawing to where the JAX frame draws: at least 95 % of the
port's non-background pixels lie within 3 px of the JAX frame's.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from icem_torch.controllers.icem import MpcICem
from icem_torch.envs import env_from_string
from icem_torch.envs.physics import render
from icem_torch.models.ground_truth import GroundTruthModel
from icem_torch.runtime.rollout import RolloutManager
from icem_torch.runtime.seeding import Seeding
from icem_torch.runtime.video import (VideoRecorder, encode_jpeg, gif_delay_cs, write_gif,
                                      write_png)
from icem_tpu.envs import env_from_string as jax_env_from_string
from icem_tpu.envs.physics import render as jax_render

# registry strings of envs with a planar or spatial model
ENVS = ("HalfCheetah", "Hopper", "Reacher", "swimmer", "Ant", "HumanoidStandup")
KW = {"HalfCheetah": dict(exclude_current_positions_from_observation=False),
      "Hopper": dict(exclude_current_positions_from_observation=False),
      "Ant": dict(exclude_current_positions_from_observation=False)}


def _envs(name):
    kw = KW.get(name, {})
    return jax_env_from_string(name, **kw), env_from_string(name, **kw)


def _pose(env, seed):
    """A random pose of the env's model, its root above the ground."""
    model = env.model
    rng = np.random.default_rng(seed)
    q = 0.4 * rng.standard_normal(model.ndof)
    if model.free_root:
        q[2 if hasattr(model, "axis") else 1] = 0.7 + 0.1 * rng.random()
    return q


@pytest.mark.parametrize("name", ENVS)
def test_host_fk_matches_jax(name):
    jenv, env = _envs(name)
    spatial = hasattr(env.model, "axis")
    fk, jfk = ((render._fk_host_spatial, jax_render._fk_host_spatial) if spatial
               else (render._fk_host, jax_render._fk_host))
    for seed in range(3):
        q = _pose(env, seed)
        for got, want in zip(fk(env.model, q), jfk(jenv.model, q)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _near(got, want, px=3):
    """The share of ``got``'s non-background pixels within ``px`` of one of
    ``want``'s."""
    drawn_got = np.any(got != 255, axis=-1)
    drawn_want = np.any(want != 255, axis=-1)
    dist = ndimage.distance_transform_edt(~drawn_want)
    return float((dist[drawn_got] <= px).mean()), int(drawn_got.sum())


@pytest.mark.parametrize("name", ENVS)
def test_frames_draw_where_the_jax_frames_draw(name):
    jenv, env = _envs(name)
    for seed in range(2):
        q = _pose(env, seed)
        # render_frame reads q, the state's first ndof entries
        state = np.concatenate([q, np.zeros(env.model.ndof)]).astype(np.float32)
        got = env.render_frame(torch.from_numpy(state))
        want = np.asarray(jenv.render_frame(state))
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        share, drawn = _near(got, want)
        assert drawn > 200 and share >= 0.95, (name, seed, share, drawn)


def test_envs_without_a_model_draw_nothing():
    assert env_from_string("ContinuousPendulum").render_frame(torch.zeros(2)) is None


def _frames(n=7, seed=0):
    """Rendered HalfCheetah frames of a moving pose."""
    model = env_from_string("HalfCheetah").model
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = 0.3 * rng.standard_normal(model.ndof)
        q[0], q[1] = 0.2 * i, 0.6
        out.append(render.render_planar(model, q))
    return out


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(float) - b.astype(float)) ** 2))


def _avi_jpegs(path):
    """The container's header frame count and the JPEG payloads of its movi
    list, parsed back from the RIFF structure."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    avih_at = data.index(b"avih") + 8
    n_frames = struct.unpack("<I", data[avih_at + 16:avih_at + 20])[0]
    assert b"vids" in data and b"MJPG" in data
    at = data.index(b"movi") + 4
    jpegs = []
    while data[at:at + 4] == b"00dc":
        size = struct.unpack("<I", data[at + 4:at + 8])[0]
        jpegs.append(data[at + 8:at + 8 + size])
        at += 8 + size + (size % 2)
    idx_at = data.index(b"idx1")
    assert struct.unpack("<I", data[idx_at + 4:idx_at + 8])[0] == 16 * len(jpegs)
    return n_frames, jpegs


def test_avi_parses_and_its_jpegs_decode(tmp_path):
    frames = _frames()
    rec = VideoRecorder(str(tmp_path), "ep0", fps=20)
    for f in frames:
        rec.append(f)
    assert rec.close() == str(tmp_path / "ep0.gif")
    n, jpegs = _avi_jpegs(tmp_path / "ep0.avi")
    assert n == len(jpegs) == len(frames)
    for jpeg, frame in zip(jpegs, frames):
        assert jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9"
        img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
        assert img.shape == frame.shape
        assert _psnr(img, frame) >= 30.0


@pytest.mark.parametrize("shape", [(45, 70), (8, 8), (1, 13)])
def test_jpeg_of_any_size_decodes(shape):
    """Sizes that are not whole 8x8 blocks, a smooth image."""
    h, w = shape
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.linspace(0, 255, w)[None]
    img[..., 1] = np.linspace(0, 255, h)[:, None]
    img[..., 2] = 90
    out = np.asarray(Image.open(io.BytesIO(encode_jpeg(img))).convert("RGB"))
    assert out.shape == img.shape and _psnr(out, img) >= 30.0


def test_gif_decodes_to_exactly_the_frames(tmp_path):
    frames = _frames(5, seed=1) + [np.full((320, 480, 3), 255, np.uint8)]
    write_gif(str(tmp_path / "a.gif"), frames, fps=20)
    im = Image.open(tmp_path / "a.gif")
    assert im.n_frames == len(frames) and im.info["loop"] == 0
    for i, frame in enumerate(frames):
        im.seek(i)
        assert im.info["duration"] == 50          # 5 centiseconds at 20 fps
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frame)


def test_gif_of_many_colours_and_its_delays(tmp_path):
    """A frame of more than 256 colours takes the 3-3-2 colour cube; the
    delay is stored in centiseconds, round(100 / fps) and at least 2."""
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    write_gif(str(tmp_path / "n.gif"), [noise, noise[::-1]], fps=10)
    im = Image.open(tmp_path / "n.gif")
    assert im.n_frames == 2 and im.info["duration"] == 100
    got = np.asarray(im.convert("RGB")).astype(int)
    assert np.abs(got - noise).max() <= 255 // 3 + 1
    assert [gif_delay_cs(f) for f in (20, 30, 60, 100, 0.5)] == [5, 3, 2, 2, 200]


def test_png_decodes_to_exactly_the_frame(tmp_path):
    frame = _frames(1, seed=3)[0]
    write_png(str(tmp_path / "f.png"), frame)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")), frame)


def test_live_frame_every_live_every_frames_and_failures_raise(tmp_path):
    frames = _frames(4, seed=4)
    rec = VideoRecorder(str(tmp_path), "ep", live_every=3)
    live = tmp_path / "live_frame.png"
    for i, f in enumerate(frames):
        rec.append(f)
        # frames 1 and 4 refresh the still
        want = frames[0] if i < 3 else frames[3]
        np.testing.assert_array_equal(np.asarray(Image.open(live)), want)
    gone = tmp_path / "gone"
    broken = VideoRecorder(str(gone), "ep")      # makes the directory
    os.rmdir(gone)
    with pytest.raises(FileNotFoundError):
        broken.append(frames[0])
    assert VideoRecorder(str(tmp_path), "empty").close() is None


class ZeroPolicy:
    def __init__(self, dim):
        self.dim = dim

    def get_action(self, obs, state=None, mode="train"):
        return np.zeros(self.dim, np.float32)


def test_rollout_manager_records_one_video_per_episode(tmp_path):
    """One AVI and GIF per episode, named <name or mode>_<counter>, with one
    frame per step, drawn before each action."""
    Seeding.set_seed(0)
    env = env_from_string("Hopper", exclude_current_positions_from_observation=False)
    out = tmp_path / "vids"
    man = RolloutManager(env, dict(task_horizon=5, record=str(out)), device="cpu")
    rollouts = man.sample(ZeroPolicy(3), mode="train", name="train", no_rollouts=2)
    assert sorted(os.listdir(out)) == ["live_frame.png", "train_0001.avi", "train_0001.gif",
                                       "train_0002.avi", "train_0002.gif"]
    for i, r in enumerate(rollouts, start=1):
        n, _ = _avi_jpegs(out / f"train_{i:04d}.avi")
        assert n == len(r) == Image.open(out / f"train_{i:04d}.gif").n_frames
    # the first frame is the episode's start state, drawn before the action
    state0 = torch.from_numpy(rollouts[0]["observations"][0])
    first = Image.open(out / "train_0001.gif")
    np.testing.assert_array_equal(np.asarray(first.convert("RGB")), env.render_frame(state0))


def test_plan_replay_record_writes_plan_videos(tmp_path):
    """do_visualize_plan="record": each get_action writes the env replay of
    the chosen plan as plan_<counter> under plan_video_dir, one frame per
    step of the horizon."""
    env = env_from_string("HalfCheetah", exclude_current_positions_from_observation=False)
    ctrl = MpcICem(env=env, forward_model=GroundTruthModel(env=env), horizon=4,
                   num_simulated_trajectories=8, do_visualize_plan="record", seed=1,
                   device="cpu", action_sampler_params=dict(elites_size=2, opt_iterations=2))
    ctrl.plan_video_dir = str(tmp_path)
    state, obs = env.reset_with_mode(torch.Generator().manual_seed(0), "train")
    ctrl.beginning_of_rollout(observation=obs, state=state)
    for _ in range(2):
        a = ctrl.get_action(obs, state)
        state, obs, _, _ = env.step(state, torch.as_tensor(a))
    for k in (1, 2):
        n, _ = _avi_jpegs(tmp_path / f"plan_{k:04d}.avi")
        assert n == 4 == Image.open(tmp_path / f"plan_{k:04d}.gif").n_frames
