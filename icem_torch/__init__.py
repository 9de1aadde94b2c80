"""icem_torch — the iCEM planning framework on PyTorch and CUDA.

A port of ``icem_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. Module
paths and names follow the JAX package, so each function has a counterpart
there with the same name. Plain tensor code is PyTorch; the population
rollout of the planar physics engine is a CUDA C++ kernel written for
Hopper (``csrc/``), with a plain PyTorch version beside it
(``envs/physics/batched.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); randomness always comes
from an explicit ``torch.Generator`` on the working device.
"""

__version__ = "0.1.0"
