"""Run one benchmark cell: build the system under test, warm it up, measure
whole episodes for a window, and check what the window produced.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``benchmark/configs/<config>.json``: the resolved settings as run, their
  source, what the window replaces, the reference task and the frozen
  operation count;
- ``benchmark/mixes/<traffic>.json``: the traffic's parameters, read by
  ``traffic.py``;
- ``benchmark/metrics/<metric>.py``: a reader with ``read(run) -> float |
  None``;
- ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.

The system under test is the port: ``icem_torch.runtime.rollout.RolloutManager``
driving ``icem_torch.controllers.icem.MpcICem`` over the env's real step,
built from the same factories ``icem_torch.main.run`` uses.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "icem_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("mixes", name)


def limits(cell: str) -> dict:
    path = BENCH / "limits" / f"{cell}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def metric_reader(name: str):
    """The module of ``benchmark/metrics/<name>.py``, loaded by path: a
    metric's name may hold dots."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(cell: str, bench: dict) -> list:
    """The per-layer metrics reported in ``cell``: those that list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def end_to_end_metrics(cell: str, bench: dict) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------------------
# the system under test


def build(cfg: dict, mx: dict, seed: int, device, overrides: dict | None = None):
    """(params, env, controller, manager) from the configuration's settings
    with the mix's rollout parameters, as ``icem_torch.main.run`` builds them.
    ``overrides`` (tests only) replace settings keys, dotted."""
    from icem_torch.main import get_controllers
    from icem_torch.models import forward_model_from_string
    from icem_torch.envs import env_from_string
    from icem_torch.runtime.config import recursive_objectify
    from icem_torch.runtime.rollout import RolloutManager
    from icem_torch.runtime.seeding import Seeding

    settings = json.loads(json.dumps(cfg["settings"]))
    settings["rollout_params"].update(mx.get("rollout_params", {}))
    for key, value in (overrides or {}).items():
        node = settings
        *path, last = key.split(".")
        for k in path:
            node = node[k]
        node[last] = value
    params = recursive_objectify(settings)
    Seeding.set_seed(seed)
    env = env_from_string(params.env, **params.get("env_params", {}))
    model = forward_model_from_string(params.forward_model)(
        env=env, device=device, **params.get("forward_model_params", {}))
    _, controller = get_controllers(params, env, model, device)
    manager = RolloutManager(env, params.rollout_params, device=device)
    return params, env, controller, manager


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = "not measured (nvidia-smi unavailable)"
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, start: float | None = None,
             control: bool = False, log=print) -> dict:
    """One run of ``cell``: set-up, the window, the check. Returns the result
    line's dict (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown`` with ``trace``, ``checks`` last) and, under
    ``"_numbers"``, everything compared. ``control``: also compute the
    numbers of the lower-precision reference put in the program's place."""
    start = time.perf_counter() if start is None else start
    bench = manifest()
    w = workload(cell, bench)
    cfg, mx = config(w["config"]), mix(w["traffic"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    setup = {}

    t = time.perf_counter()
    if on_card:
        from icem_torch.ops._build import load_library
        setup["build_s"] = load_library()[1].seconds
    setup["extension_load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    params, _, controller, manager = build(cfg, mx, seed, device, overrides)
    setup["construct_s"] = time.perf_counter() - t

    from icem_torch.runtime import graphs
    horizon = manager.task_horizon
    plan = traffic.Plan(mx, seed, horizon)
    recorder = traffic.Recorder(plan, trace_steps=plan.trace_steps if trace else None,
                                device=device)
    path = traffic.install(manager, controller, recorder)

    t = time.perf_counter()
    traffic.warm_up(manager, controller, mx)
    if on_card:
        torch.cuda.synchronize()
    setup["warm_up_s"] = time.perf_counter() - t
    setup["capture_s"] = graphs.CAPTURE_SECONDS

    recorder.arm()
    window_start = time.perf_counter()
    setup_s = window_start - start
    episodes = traffic.window(manager, controller, seconds, recorder)
    window_end = episodes[-1].end
    recorder.disarm()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup["memory_peak_bytes"] = memory_peak

    steps = sum(e.steps for e in episodes)
    attempted = horizon * len(episodes)
    run = SimpleNamespace(config=cfg, episodes=episodes, steps=steps,
                          window_s=window_end - window_start, capture_s=setup["capture_s"],
                          recorder=recorder, path=path, trace=recorder.trace_summary)

    metrics = {}
    if not trace:
        for m in end_to_end_metrics(cell, bench):
            value = setup_s if m["name"] == "setup_s" else end_to_end_reader(m["name"])(run)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in per_layer_metrics(cell, bench):
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(f"[setup] {json.dumps(setup)}")
    # the program's state goes before the reference runs: a reference run
    # on the card would otherwise share the peak
    del manager, controller
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check.numbers(cfg, params, recorder, episodes, seed)
    check_s = time.perf_counter() - t
    result = {"correct": None, "attempted": attempted,
              "failed": attempted - steps, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    lim = limits(cell)
    checks = {name: {"value": value, "limit": lim.get(name, {}).get("limit")}
              for name, value in numbers.items()}
    result["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in checks.values()) and bool(checks)
    result["checks"] = checks
    result["_numbers"] = numbers
    result["_setup"] = dict(setup, setup_s=setup_s, check_s=check_s,
                            episodes=[e.end - e.start for e in episodes])
    if control:
        result["_control"] = check.numbers(cfg, params, recorder, episodes, seed, control=True)
    return result


# ---------------------------------------------------------------------------
# end-to-end metrics (host clock)


def env_steps_per_s(run) -> float:
    """All env steps of the window's whole episodes over the wall time they took."""
    return run.steps / run.window_s


def control_step_ms_p95(run) -> float:
    """95th percentile of every control step of the window: one
    ``get_action`` call's start to the next within an episode."""
    return percentile(run.recorder.control_step_ms(), 95)


END_TO_END = {"env_steps_per_s": env_steps_per_s, "control_step_ms_p95": control_step_ms_p95}


def end_to_end_reader(name: str):
    """The function of an end-to-end metric: its name up to the first dot,
    so that ``env_steps_per_s.host_loop`` is the rate under a bound of its
    own."""
    return END_TO_END[name.split(".")[0]]


def percentile(values, q: float) -> float:
    """The q-th percentile, linearly interpolated between order statistics
    (numpy's default)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), q))


def median(values) -> float:
    return float(statistics.median(values))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    import sys

    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in FORBIDDEN})


def cache_environment() -> dict:
    """Fixed cache directories inside the checkout for every build and kernel
    cache the program or torch may use; a value the caller set is kept."""
    cache = ROOT / "build" / "bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "CUDA_CACHE_PATH": str(cache / "cuda"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def apply_cache_environment():
    for key, value in cache_environment().items():
        os.environ.setdefault(key, value)
