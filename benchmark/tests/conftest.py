"""Fixtures of the benchmark's tests. A test that needs the card takes
``cuda_device`` and carries the ``cuda`` marker; the fixture decides, at run
time, whether there is a card."""

import pytest
import torch

# a tiny planner and episode on the CPU: the program runs its plain
# versions there, which the frozen reference copies to the bit
TINY = {"controller_params.num_simulated_trajectories": 8, "controller_params.horizon": 4,
        "rollout_params.task_horizon": 6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")
