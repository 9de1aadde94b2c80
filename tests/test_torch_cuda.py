"""The rollout kernels' launch paths on a CUDA card.

These tests need the card and skip without one. On a machine with an H100
and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from icem_torch.envs.ant3d import Ant3D
from icem_torch.envs.cheetah import HalfCheetah, make_cheetah_model
from icem_torch.envs.humanoid3d import HumanoidStandup3D
from icem_torch.envs.physics.planar import PlanarModel
from icem_torch.envs.physics.spatial import SpatialModel
from icem_torch.ops import planar_rollout as pr
from icem_torch.ops import spatial_rollout as sr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(P, h, device, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-0.1, 0.1, (P, 9)).astype(np.float32)
    QD = (0.1 * rng.standard_normal((P, 9))).astype(np.float32)
    A = rng.uniform(-1, 1, (P, h, 6)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (Q, QD, A)]


@pytest.mark.parametrize("P", [1, 127, 1000])
def test_kernel_matches_plain_version(cuda, P):
    model = make_cheetah_model(dt=0.05, n_substeps=20)
    Q, QD, A = _inputs(P, 3, cuda)
    before = pr.LAUNCHES
    qs, qds = pr.rollout_planar(model, Q, QD, A)
    torch.cuda.synchronize()
    assert pr.LAUNCHES == before + 1
    rq, rqd = pr.rollout_planar_reference(model, Q, QD, A)
    # tests/test_pallas_rollout.py's tolerance over the first three steps
    torch.testing.assert_close(qs, rq, atol=1e-3, rtol=0)
    assert bool(torch.isfinite(qds).all())


def test_env_step_is_one_launch(cuda):
    env = HalfCheetah(exclude_current_positions_from_observation=True)
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    before = pr.LAUNCHES
    new_state, obs, reward, done = env.step(state, torch.zeros(6, device=cuda))
    assert pr.LAUNCHES == before + 1
    assert new_state.device.type == "cuda" and tuple(obs.shape) == (17,)


def test_kernel_raises_on_what_it_does_not_take(cuda):
    model = make_cheetah_model()
    Q, QD, A = _inputs(8, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        pr.rollout_planar(model, Q.double(), QD.double(), A)
    with pytest.raises(ValueError, match="on cpu"):
        pr.rollout_planar(model, Q, QD.cpu(), A)
    arm = PlanarModel(parent=(-1, 0), anchor=np.zeros((2, 2), np.float32),
                      com=np.zeros((2, 2), np.float32), mass=np.ones(2, np.float32),
                      inertia=np.ones(2, np.float32), free_root=False,
                      actuator_dof=(0, 1), gear=np.ones(2, np.float32))
    with pytest.raises(ValueError, match="not instantiated"):
        pr.rollout_planar(arm, torch.zeros(8, 2, device=cuda), torch.zeros(8, 2, device=cuda),
                          torch.zeros(8, 2, 2, device=cuda))


# ---------------------------------------------------------------------------
# the spatial rollout kernel (B2)

SPATIAL = {"ant3d": Ant3D, "humanoid3d": HumanoidStandup3D}


def _spatial_inputs(env, P, h, device, seed=0):
    """States near the env's start distribution and uniform actions."""
    model = env.model
    n, na = model.ndof, len(model.actuator_dof)
    gen = torch.Generator(device=device).manual_seed(seed)
    S = torch.stack([env.init_state(gen) for _ in range(8)])[torch.arange(P) % 8]
    Q = S[:, :n] + 0.05 * torch.randn(P, n, generator=gen, device=device)
    QD = S[:, n:] + 0.1 * torch.randn(P, n, generator=gen, device=device)
    A = torch.rand(P, h, na, generator=gen, device=device) * 2 - 1
    return Q, QD, A


@pytest.mark.parametrize("name", list(SPATIAL))
@pytest.mark.parametrize("P", [1, 127, 1000])
def test_spatial_kernel_matches_plain_version(cuda, name, P):
    env = SPATIAL[name]()
    Q, QD, A = _spatial_inputs(env, P, 3, cuda)
    before = sr.LAUNCHES
    qs, qds = sr.rollout_spatial(env.model, Q, QD, A)
    torch.cuda.synchronize()
    assert sr.LAUNCHES == before + 1
    rq, _ = sr.rollout_spatial_reference(env.model, Q, QD, A)
    assert bool(torch.isfinite(qs).all() and torch.isfinite(qds).all())
    # tests/test_pallas_rollout.py's spatial bulk rule over three steps
    d = (qs - rq).abs()
    assert float(torch.quantile(d.flatten(), 0.999)) < 1e-3 and float(d.max()) < 5e-2


def test_spatial_env_step_is_one_launch(cuda):
    env = Ant3D(exclude_current_positions_from_observation=False)
    state = env.init_state(torch.Generator(device=cuda).manual_seed(0))
    before = sr.LAUNCHES
    new_state, obs, reward, done = env.step(state, torch.zeros(8, device=cuda))
    assert sr.LAUNCHES == before + 1
    assert new_state.device.type == "cuda" and tuple(obs.shape) == (28,)


def test_spatial_kernel_raises_on_what_it_does_not_take(cuda):
    model = Ant3D().model
    Q, QD, A = _spatial_inputs(Ant3D(), 8, 2, cuda)
    with pytest.raises(TypeError, match="float32"):
        sr.rollout_spatial(model, Q.double(), QD.double(), A)
    with pytest.raises(ValueError, match="on cpu"):
        sr.rollout_spatial(model, Q, QD.cpu(), A)
    chain = SpatialModel(parent=(-1, 0), anchor=np.zeros((2, 3), np.float32),
                         axis=np.eye(3, dtype=np.float32)[:2],
                         com=np.zeros((2, 3), np.float32), mass=np.ones(2, np.float32),
                         inertia=np.ones((2, 3), np.float32), free_root=False,
                         actuator_dof=(0, 1), gear=np.ones(2, np.float32))
    with pytest.raises(ValueError, match="not instantiated"):
        sr.rollout_spatial(chain, torch.zeros(8, 2, device=cuda),
                           torch.zeros(8, 2, device=cuda), torch.zeros(8, 2, 2, device=cuda))
