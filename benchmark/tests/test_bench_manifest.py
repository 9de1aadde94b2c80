"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"] for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric(cell):
    e2e = {m["name"] for m in harness.end_to_end_metrics(cell, BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_metrics(cell, BENCH)
    assert layer
    # a layer metric moves an end-to-end metric the cell reports
    assert all(m["moves"] in e2e for m in layer)


def test_workload_lists_name_cells_that_exist():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= CELLS


DATA_FILES = ([("configs", c["name"]) for c in BENCH["configs"]]
              + [("mixes", t) for t in sorted({w["traffic"] for w in BENCH["workloads"]})]
              + [("limits", w) for w in sorted(CELLS)])


@pytest.mark.parametrize("kind,name", DATA_FILES)
def test_every_data_file_is_found_by_name(kind, name):
    path = harness.BENCH / kind / f"{name}.json"
    assert path.is_file()
    data = json.loads(path.read_text())
    if kind == "configs":
        entry = next(c for c in BENCH["configs"] if c["name"] == name)
        assert entry["file"] == f"benchmark/configs/{name}.json"
        assert data["name"] == name and data["source"] == entry["source"]
        assert data["reduced"] == entry["reduced"]
        assert (harness.BENCH / "reference" / f"{data['reference']}.py").is_file()
    if kind == "limits":
        assert data["limits"] and all("limit" in v for v in data["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_is_found_by_name(metric):
    reader = harness.metric_reader(metric)
    assert callable(reader.read)


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration, a mix and a metric added as new files and entries,
    found by name with no edit to an existing file."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    configs = root / "benchmark" / "configs"
    cfg = json.loads((configs / "halfcheetah_running.i-cem-blitz.json").read_text())
    cfg["name"] = "halfcheetah_running.i-cem-wide"
    (configs / "halfcheetah_running.i-cem-wide.json").write_text(json.dumps(cfg))
    (root / "benchmark/mixes/short_episodes.json").write_text(json.dumps(
        {"rollout_params": {"fuse_on_device": "auto", "task_horizon": 100},
         "checked_steps_per_episode": 4, "warm_up_steps": 3}))
    (root / "benchmark/metrics/episodes_in_window.py").write_text(
        "def read(run):\n    return float(len(run.episodes))\n")
    bench["workloads"].append({"name": "cheetah_wide.short", "config": cfg["name"],
                               "traffic": "short_episodes", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "episodes_in_window", "unit": "episodes",
                               "better": "higher", "source": "host_clock", "layer": "traffic",
                               "moves": "env_steps_per_s", "workloads": ["cheetah_wide.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "benchmark")
    w = harness.workload("cheetah_wide.short")
    assert harness.config(w["config"])["name"] == "halfcheetah_running.i-cem-wide"
    assert harness.mix(w["traffic"])["checked_steps_per_episode"] == 4
    layer = [m["name"] for m in harness.per_layer_metrics("cheetah_wide.short", harness.manifest())]
    assert "episodes_in_window" in layer
    assert harness.metric_reader("episodes_in_window").read(type("R", (), {"episodes": [1, 2]})) == 2.0


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_embedded_settings_are_the_shipped_file_resolved(name):
    """Each configuration file's ``settings`` is its ``settings_file`` as the
    program resolves it, apart from the keys in ``reduced``."""
    from icem_torch.runtime.config import resolve_settings

    cfg = harness.config(name)
    shipped = json.loads(json.dumps(resolve_settings(str(harness.ROOT / cfg["settings_file"]))))
    embedded = cfg["settings"]
    assert set(shipped) == set(embedded)
    assert {k: v for k, v in shipped.items() if k not in cfg["reduced"]} == \
        {k: v for k, v in embedded.items() if k not in cfg["reduced"]}
