"""icem_torch's settings resolution against the JAX package's: every shipped
settings file resolves to the same dict, command-line overrides apply the
same way, and the resolved dict is immutable."""

import json
from pathlib import Path

import pytest

from icem_torch.runtime import config as tcfg
from icem_tpu.runtime import config as jcfg

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = sorted((ROOT / "settings").rglob("*.json"))


def test_every_settings_file_is_found():
    assert len(SETTINGS) == 36


@pytest.mark.parametrize("path", SETTINGS, ids=lambda p: str(p.relative_to(ROOT / "settings")))
def test_settings_resolve_as_in_jax(path):
    port = tcfg.resolve_settings(str(path))
    ref = jcfg.resolve_settings(str(path))
    assert isinstance(port, tcfg.ParamDict)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port == ref


OVERRIDES = ["controller_params.horizon=4",
             "controller_params.action_sampler_params.noise_beta=0.5",
             "rollout_params.use_env_states=true", "rollout_params.record=false",
             "checkpoints.restart_every_n_iter=null", "new.nested.key=[1, 2]",
             "model_dir=/tmp/run", "seed=3", "env_params.name='x'"]


def test_overrides_apply_as_in_jax():
    path = str(ROOT / "settings" / "ant" / "i-cem-blitz.json")
    port = tcfg.apply_overrides(tcfg.resolve_settings(path), OVERRIDES)
    ref = jcfg.apply_overrides(jcfg.resolve_settings(path), OVERRIDES)
    assert port == ref
    assert port.controller_params.horizon == 4
    assert port.controller_params.action_sampler_params.noise_beta == 0.5
    assert port.rollout_params.use_env_states is True
    assert port.rollout_params.record is False
    assert port.checkpoints.restart_every_n_iter is None
    assert port.new.nested.key == [1, 2]
    assert port.model_dir == "/tmp/run" and port.seed == 3
    with pytest.raises(ValueError, match="key=value"):
        tcfg.apply_overrides(port, ["no_equals_sign"])


def test_params_from_cmd_line_as_in_jax():
    argv = ["main", str(ROOT / "settings" / "halfcheetah_running" / "i-cem-blitz.json"),
            "training_iterations=2"]
    assert tcfg.params_from_cmd_line(argv) == jcfg.params_from_cmd_line(argv)
    literal = ["main", "{'env': 'HalfCheetah', 'controller_params': {'horizon': 3}}", "seed=1"]
    assert tcfg.params_from_cmd_line(literal) == jcfg.params_from_cmd_line(literal)
    with pytest.raises(ValueError):
        tcfg.params_from_cmd_line(["main"])


def test_paramdict_is_immutable():
    p = tcfg.resolve_settings(str(ROOT / "settings" / "halfcheetah_running" / "i-cem-blitz.json"))
    assert p["env"] == p.env == "HalfCheetah"
    assert isinstance(p.controller_params, tcfg.ParamDict)
    for mutate in (lambda: setattr(p, "env", "Ant"), lambda: p.__setitem__("env", "Ant"),
                   lambda: delattr(p, "env"),
                   lambda: p.controller_params.__setitem__("horizon", 1)):
        with pytest.raises(TypeError):
            mutate()
    with pytest.raises(AttributeError):
        _ = p.does_not_exist
    plain = p.get_pickleable()
    assert type(plain) is dict and type(plain["controller_params"]) is dict


def test_save_settings_to_json(tmp_path):
    p = tcfg.resolve_settings(str(ROOT / "settings" / "ant" / "i-cem-blitz.json"))
    tcfg.save_settings_to_json(p, str(tmp_path / "a"))
    jcfg.save_settings_to_json(p, str(tmp_path / "b"))
    assert (tmp_path / "a" / "settings.json").read_text() == \
        (tmp_path / "b" / "settings.json").read_text()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_the_wide_setting_is_blitz_at_the_projects_width():
    """``i-cem-wide`` resolves to pop 32,768 and 512 elites, every other key
    as ``i-cem-blitz`` (the resolver lets a deeper ancestor win, so a
    setting inheriting ``i-cem-blitz`` itself would get the defaults' beta)."""
    from icem_torch.controllers.icem import ICemConfig

    folder = ROOT / "settings" / "halfcheetah_running"
    wide = tcfg.resolve_settings(str(folder / "i-cem-wide.json")).get_pickleable()
    blitz = tcfg.resolve_settings(str(folder / "i-cem-blitz.json")).get_pickleable()
    flat_wide, flat_blitz = _flat(wide), _flat(blitz)
    changed = {k for k in set(flat_wide) | set(flat_blitz) if flat_wide.get(k) != flat_blitz.get(k)}
    assert changed == {"controller_params.num_simulated_trajectories",
                       "controller_params.action_sampler_params.elites_size", "model_dir"}
    cp = wide["controller_params"]
    asp = cp["action_sampler_params"]
    assert cp["num_simulated_trajectories"] == 32768
    assert (asp["elites_size"], asp["noise_beta"]) == (512, 0.25)
    assert wide["model_dir"] == "results/icem/halfcheetah_running/i-cem-wide"
    cfg = ICemConfig(num_simulated_trajectories=32768, horizon=cp["horizon"],
                     factor_decrease_num=cp["factor_decrease_num"], action_dim=6, **asp)
    assert cfg.population_schedule == (32768, 26214, 20971) and cfg.elites_kept == 153
