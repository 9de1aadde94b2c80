"""Multi-process bootstrap: ``torch.distributed.init_process_group`` plumbing.

Counterpart of ``icem_tpu/parallel/multihost.py``. Where the JAX package
wires its processes into one runtime with ``jax.distributed.initialize``,
this one starts the default torch.distributed process group: one process
(rank) per card, and the planners' ``sharded`` option then spans every rank
(``parallel/plan.py``).

Launch (env-gated so single-process runs pay nothing), either with torchrun

    ICEM_MULTIHOST=1 torchrun --nproc-per-node 4 -m icem_torch.main \\
        settings/<exp>/<cfg>.json

or with the launch line of the JAX package, one command per process:

    # process 0 (also the coordinator)
    ICEM_MULTIHOST=1 ICEM_COORDINATOR=host0:8476 ICEM_NUM_PROCESSES=2 \\
        ICEM_PROCESS_ID=0 python -m icem_torch.main settings/<exp>/<cfg>.json
    # process 1
    ICEM_MULTIHOST=1 ICEM_COORDINATOR=host0:8476 ICEM_NUM_PROCESSES=2 \\
        ICEM_PROCESS_ID=1 python -m icem_torch.main settings/<exp>/<cfg>.json

Without ``ICEM_COORDINATOR`` the group is read from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``env://``).
The backend is NCCL for a run on the card and gloo for ``--device cpu``.

Multi-process contract: every process runs the same program with the same
settings and seed, so the replicated planner state is identical on every
rank; only the population shards differ.
"""

from __future__ import annotations

import os
import secrets

import torch
import torch.distributed as dist

_initialized = False


def _int_env(name: str, default: str) -> int:
    raw = os.environ.get(name, default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer — check the multihost launch line "
            f"(see icem_torch/parallel/multihost.py)") from None


def maybe_initialize_distributed(verbose: bool = True, device=None) -> bool:
    """Start the default process group when ``ICEM_MULTIHOST`` is set.

    ``device``: the run's device; "cpu" gives gloo, anything else (the card,
    the default) NCCL, and then this process's card is bound before the
    first CUDA operation: ``LOCAL_RANK`` where torchrun sets it, else the
    process id modulo the cards on the host. Idempotent; returns whether the
    group is (now) up. A failed launch of more than one process raises: it
    must never degrade into duplicate single-process runs.
    """
    global _initialized
    if _initialized:
        return True
    if not os.environ.get("ICEM_MULTIHOST"):
        return False
    if dist.is_initialized():  # the caller started it
        _initialized = True
        return True

    coord = os.environ.get("ICEM_COORDINATOR")
    if coord:
        num_processes = _int_env("ICEM_NUM_PROCESSES", "1")
        process_id = _int_env("ICEM_PROCESS_ID", "0")
        kwargs = dict(init_method=f"tcp://{coord}", world_size=num_processes,
                      rank=process_id)
    else:  # torchrun's environment
        num_processes = _int_env("WORLD_SIZE", "1")
        process_id = _int_env("RANK", "0")
        kwargs = dict(init_method="env://")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if on_cpu else "nccl"
    if not on_cpu and torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(_int_env("LOCAL_RANK", "0") if local is not None
                              else process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (RuntimeError, ValueError) as e:
        if num_processes > 1:
            # degrading to one process here would silently run a DUPLICATE
            # single-process experiment on every other rank
            raise RuntimeError(
                f"init_process_group failed for an explicit {num_processes}-process "
                f"launch: {e}") from e
        # one process: a launch-order or environment bug, surfaced loudly
        print(f"WARNING: init_process_group failed: {e}")
        return False
    _initialized = True
    if verbose:
        where = "cpu" if on_cpu else f"cuda:{torch.cuda.current_device()}"
        print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()} up, "
              f"{backend} on {where}")
    return True


def shared_seed(seed):
    """``seed``, or where it is None and a process group is up, one seed
    drawn on rank 0 and sent to every rank: the ranks' replicated planner
    state must start from one seed."""
    if seed is not None or not (dist.is_available() and dist.is_initialized()):
        return seed
    box = [secrets.randbits(31) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def process_zero() -> bool:
    """True on the process that should write checkpoints, metrics and
    videos: rank 0 where a process group is up, else the only process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True
