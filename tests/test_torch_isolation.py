"""icem_torch and chip_smoke.py stand alone: neither imports JAX or the JAX
package, and the port's entry points run on the card unless told otherwise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from icem_torch.device import resolve_device
from icem_torch.runtime.seeding import Seeding

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "icem_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "icem_tpu")


def _modules():
    mods = []
    for path in sorted((ROOT / "icem_torch").rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Seeding.generator_for("controller/icem")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_seeding_streams_are_named_and_reproducible():
    Seeding.set_seed(7)
    a = torch.rand(4, generator=Seeding.generator_for("a", "cpu"))
    b = torch.rand(4, generator=Seeding.generator_for("b", "cpu"))
    first = torch.rand(4, generator=Seeding.next_generator("controller/icem", "cpu"))
    second = torch.rand(4, generator=Seeding.next_generator("controller/icem", "cpu"))
    Seeding.set_seed(7)
    assert torch.equal(a, torch.rand(4, generator=Seeding.generator_for("a", "cpu")))
    assert torch.equal(first, torch.rand(4, generator=Seeding.next_generator(
        "controller/icem", "cpu")))
    assert not torch.equal(a, b) and not torch.equal(first, second)
    Seeding.set_seed(8)
    assert not torch.equal(a, torch.rand(4, generator=Seeding.generator_for("a", "cpu")))


def test_chip_smoke_fails_without_a_card(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.main()
