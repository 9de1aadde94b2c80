"""Experiment driver: the outer training loop.

Counterpart of ``icem_tpu/main.py`` (the reference's icem/main.py:82-243):

    settings resolution -> env/model/controller factories -> checkpoint
    restore -> [iterate: collect rollouts -> log reward info -> extend/replace
    buffer -> train forward model -> eval rollouts -> solve-metric bookkeeping
    -> checkpoint] -> final checkpoint

Episodes run on the card (``runtime/rollout.py``) unless the caller asks for
the CPU: ``run(params, device="cpu")``, or ``--device cpu`` on the command
line. The device is a flag, not a settings key, so settings files and the
``settings.json`` a run writes stay as the JAX driver reads and writes them.
On the card every plan step, device-episode control step and host-loop env
step replays a CUDA graph (``runtime/graphs.py``); ``run(params,
eager=True)``, or ``--eager``, runs them eagerly (``disable_graphs()``), also
a flag and not a settings key.

Usage:
    python -m icem_torch.main settings/halfcheetah_running/i-cem-blitz.json \\
        [key=value overrides] [--device cpu] [--eager]

On several cards, one process per card: ``ICEM_MULTIHOST=1 torchrun
--nproc-per-node N -m icem_torch.main <settings>`` (or the ``ICEM_*`` launch
line of ``parallel/multihost.py``); the shipped ``"sharded": "auto"``
planners then shard their population over the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from collections import deque

from icem_torch.controllers import controller_from_string
from icem_torch.device import resolve_device
from icem_torch.envs import env_from_string
from icem_torch.models import forward_model_from_string
from icem_torch.parallel.multihost import maybe_initialize_distributed, shared_seed
from icem_torch.runtime.buffer import RolloutBuffer
from icem_torch.runtime.checkpoint import CheckpointManager, MainState
from icem_torch.runtime.config import params_from_cmd_line, save_settings_to_json
from icem_torch.runtime.graphs import disable_graphs
from icem_torch.runtime.metrics import get_logger
from icem_torch.runtime.rollout import RolloutManager, compute_reward_info
from icem_torch.runtime.seeding import Seeding

VALID_DATA_SOURCES = {"env", "policy", "expert"}


def _build_controller(cls, env, forward_model, kwargs, device):
    """Construct via the explicit ``needs_forward_model`` class flag, so a
    TypeError from bad controller kwargs propagates (main.py:26-54)."""
    if getattr(cls, "needs_forward_model", False):
        if forward_model is None:
            raise AttributeError(
                f"{cls.__name__} needs a forward model but params.forward_model "
                f"is 'none'")
        return cls(env=env, forward_model=forward_model, device=device, **kwargs)
    return cls(env=env, device=device, **kwargs)


def get_controllers(params, env, forward_model, device=None):
    """Build initial + main controllers on ``device`` (reference: main.py:26-54)."""
    initial_controller = None
    name = params.get("initial_controller")
    if name not in (None, "none", "null"):
        cls = controller_from_string(name)
        kwargs = dict(params.get("initial_controller_params", {}))
        initial_controller = _build_controller(cls, env, forward_model, kwargs, device)

    cls = controller_from_string(params.controller)
    kwargs = dict(params.controller_params)
    main_controller = _build_controller(cls, env, forward_model, kwargs, device)

    if getattr(main_controller, "needs_data", False):
        sources = params.get("controller_data_sources")
        if not sources:
            raise AttributeError("controller needs data to be trained but no source given")
        for s in sources:
            if s not in VALID_DATA_SOURCES:
                raise KeyError(f"Invalid data source '{s}', valid: {VALID_DATA_SOURCES}")
    return initial_controller, main_controller


def run(params, device=None, eager: bool = False) -> dict:
    """One full experiment on ``device`` (the card unless told otherwise);
    returns the accumulated reward dict. ``eager``: no CUDA graph, every
    compiled step runs eagerly (``disable_graphs()``)."""
    with disable_graphs() if eager else contextlib.nullcontext():
        return _run(params, device)


def _run(params, device) -> dict:
    # multi-process entry (env-gated, before the first CUDA operation): it
    # binds this rank's card, and sharded='auto' planners then span every
    # rank (parallel/multihost.py documents the launch line)
    maybe_initialize_distributed(device=device)
    device = resolve_device(device)
    model_dir = params.get("model_dir", "results/default")
    os.makedirs(model_dir, exist_ok=True)
    save_settings_to_json(params, model_dir)
    logger = get_logger(model_dir)

    Seeding.set_seed(shared_seed(params.get("seed")))
    logger.info(f"Using seed {Seeding.SEED} on {device}")

    env = env_from_string(params.env, **params.get("env_params", {}))
    forward_model = None
    if params.get("forward_model", "none") != "none":
        forward_model = forward_model_from_string(params.forward_model)(
            env=env, device=device, **params.get("forward_model_params", {}))

    initial_controller, main_controller = get_controllers(params, env, forward_model, device)

    rollout_buffer = RolloutBuffer()
    rollout_buffer_eval = RolloutBuffer()
    rollout_buffer_expert = RolloutBuffer()
    rollout_buffer_expert_all = RolloutBuffer()

    main_state = MainState(0, 0)
    reward_info = {}
    reward_info_full: dict = {}

    if "checkpoints" in params:
        cpm = CheckpointManager(model_dir=model_dir, **params.checkpoints)
        cpm.load_buffer(rollout_buffer=rollout_buffer, suffix="")
        if params.get("evaluation_rollouts", 0) > 0:
            cpm.load_buffer(rollout_buffer=rollout_buffer_eval, suffix="_eval")
        if forward_model is not None:
            cpm.load_forward_model(forward_model)
        cpm.load_controller(main_controller)
        reward_info_full = cpm.load_reward_dict(reward_info_full)
        cpm.load_main_state(main_state)
        # resume the auto-stepped metric streams where they left off
        logger.step_per_key.update(main_state.metric_steps)
    else:
        cpm = CheckpointManager(model_dir=model_dir, load=False, save=False)

    def save_checkpoint(final: bool = False):
        step = main_state.iteration
        if cpm.save and (final or step % cpm.save_every_n_iter == 0):
            cpm.update_checkpoint_dir(step)
            main_state.metric_steps = dict(logger.step_per_key)
            cpm.save_main_state(main_state)
            for buf, suffix in ((rollout_buffer, ""), (rollout_buffer_eval, "_eval"),
                                (rollout_buffer_expert, "_expert"),
                                (rollout_buffer_expert_all, "_expert_all")):
                if len(buf) > 0:
                    cpm.store_buffer(rollout_buffer=buf, suffix=suffix)
            cpm.store_forward_model(forward_model)
            cpm.store_controller(main_controller)
            cpm.save_reward_dict(reward_info_full)
            cpm.finalized_checkpoint()

    # whether iteration 0 is an initial-controller iteration is a property of
    # the config; resuming with loaded buffers only skips re-collecting that
    # data, it must not shrink the total iteration count
    has_initial_phase = (initial_controller is not None
                         and params.get("initial_number_of_rollouts", 0) > 0)
    do_initial_rollouts = has_initial_phase and not cpm.were_buffers_loaded

    total_iterations = params.training_iterations + int(has_initial_phase)
    current_max_iterations = total_iterations
    if cpm.do_restarting:
        window = cpm.restart_every_n_iter
        if main_state.iteration + window < total_iterations:
            current_max_iterations = (main_state.iteration + window
                                      + int(do_initial_rollouts))
            logger.info(f"Elastic restart: running only {window} iterations now")

    rollout_man = RolloutManager(env, params.rollout_params, device=device)
    avg_return_history = deque(maxlen=10)
    min_iters_to_solve = params.training_iterations

    for iteration in range(main_state.iteration, current_max_iterations):
        logger.info(f"Current iteration: {iteration}")
        main_state.iteration = iteration
        # resumed runs must not replay iteration-0 episode streams
        rollout_man.set_epoch(iteration)
        is_init_iteration = do_initial_rollouts and iteration == 0
        start_time = time.time()

        if is_init_iteration:
            controller = initial_controller
            number_of_rollouts = params.initial_number_of_rollouts
            render = params.rollout_params.get("render_initial", False)
        else:
            controller = main_controller
            number_of_rollouts = params.get("number_of_rollouts", 1)
            render = params.rollout_params.get("render", False)

        new_rollouts = RolloutBuffer(rollouts=rollout_man.sample(
            controller, render=render, mode="train", name="train",
            no_rollouts=number_of_rollouts))
        info = compute_reward_info(new_rollouts, prefix="train_",
                                   exec_time=time.time() - start_time)
        reward_info.update(info)
        for k, v in info.items():
            logger.log(v, key=k, step=iteration)
        # cumulative successful-rollout counter (checkpointed with MainState)
        main_state.successful_rollouts += sum(
            1 for r in new_rollouts
            if "successes" in r and len(r) > 0 and float(r["successes"][-1]) > 0)
        if main_state.successful_rollouts:
            logger.info(f"Successful rollouts: {main_state.successful_rollouts}")

        if params.get("append_data", False):
            rollout_buffer.extend(new_rollouts)
        else:
            rollout_buffer = new_rollouts

        if forward_model is not None:
            train_info = forward_model.train(rollout_buffer)
            for k, v in (train_info or {}).items():
                logger.log(v, key=f"model_{k}", step=iteration)

        if not is_init_iteration and params.get("evaluation_rollouts", 0) > 0:
            eval_rollouts = RolloutBuffer(rollouts=rollout_man.sample(
                controller, render=params.rollout_params.get("render_eval", False),
                mode="evaluate", name="eval",
                no_rollouts=params.evaluation_rollouts))
            if params.get("append_data_eval", False):
                rollout_buffer_eval.extend(eval_rollouts)
            else:
                rollout_buffer_eval = eval_rollouts
            info = compute_reward_info(eval_rollouts, prefix="eval_")
            reward_info.update(info)
            for k, v in info.items():
                logger.log(v, key=k, step=iteration)

        if "avg_return_required_to_solve" in params:
            avg_return_history.append(reward_info["train_mean_return"])
            if all(r >= params.avg_return_required_to_solve for r in avg_return_history):
                min_iters_to_solve = min(min_iters_to_solve, main_state.iteration)
            reward_info["required_iterations_to_solve"] = min_iters_to_solve
            logger.log(min_iters_to_solve, key="required_iterations_to_solve",
                       step=iteration)

        reward_info_full.setdefault("step", []).append(iteration)
        for k, v in reward_info.items():
            reward_info_full.setdefault(k, []).append(v)
        save_checkpoint()

    env.close()
    save_checkpoint(final=True)
    logger.info(json.dumps({k: v[-3:] for k, v in reward_info_full.items()}, default=str))
    logger.close()
    return reward_info_full


def main(argv=None):
    argv = sys.argv if argv is None else argv
    parser = argparse.ArgumentParser(
        prog="python -m icem_torch.main",
        description="Run one experiment from a settings file or dict literal, with "
                    "key=value overrides.")
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the plain PyTorch versions on the CPU; "
                             "default: the CUDA device")
    parser.add_argument("--eager", action="store_true",
                        help="run the steps eagerly instead of replaying CUDA graphs")
    args, rest = parser.parse_known_args(argv[1:])
    params = params_from_cmd_line([argv[0]] + rest)
    return run(params, device=args.device, eager=args.eager)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
