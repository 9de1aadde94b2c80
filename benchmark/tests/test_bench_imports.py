"""What a run and the reference import, checked in fresh interpreters, and
the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = str(harness.ROOT)


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = """
import json, sys
from benchmark import harness
from benchmark.tests.conftest import TINY
for m in harness.manifest()["per_layer"]:
    harness.metric_reader(m["name"])
harness.run_cell("cheetah_blitz.host_loop", 3, 0.0, False, "cpu", overrides=TINY,
                 log=lambda m: None)
print(json.dumps([sorted({n.split('.')[0] for n in sys.modules}), harness.forbidden_modules()]))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert "icem_torch" in tops
    assert found == [] and not {"jax", "jaxlib", "flax", "icem_tpu"} & set(tops)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["icem_torch.main", "jaxtyping", "icem_tpu_x"]) == []
    assert harness.forbidden_modules(["jax.numpy", "icem_tpu.ops", "flax"]) == \
        ["flax", "icem_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_program():
    code = """
import json, sys, pkgutil, importlib
import benchmark.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("benchmark.reference." + m.name)
import benchmark.check, benchmark.roofline
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "icem_torch" not in tops and not {"jax", "jaxlib", "icem_tpu"} & tops


def test_without_a_card_a_run_prints_no_result():
    if harness.torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "cheetah_blitz.episodes", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_a_run_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "cheetah_blitz.episodes", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
