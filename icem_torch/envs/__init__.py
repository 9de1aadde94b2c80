"""Environment registry.

Counterpart of ``icem_tpu/envs/__init__.py``: registry strings resolve to the
same environments, so settings files name them unchanged. It holds the envs
ported so far; any other name raises ``ImportError`` naming the known ones.
"""

from importlib import import_module

_ENV_REGISTRY = {
    "HalfCheetah": ("icem_torch.envs.cheetah", "HalfCheetah"),
    "Ant": ("icem_torch.envs.ant3d", "Ant3D"),
    "HumanoidStandup": ("icem_torch.envs.humanoid3d", "HumanoidStandup3D"),
    "Humanoid": ("icem_torch.envs.humanoid3d", "Humanoid3D"),
}


def env_from_string(env_string: str, **env_params):
    if env_string not in _ENV_REGISTRY:
        raise ImportError(f"add '{env_string}' entry to the env registry; "
                          f"known: {sorted(_ENV_REGISTRY)}")
    module_name, class_name = _ENV_REGISTRY[env_string]
    cls = getattr(import_module(module_name), class_name)
    return cls(name=env_string, **env_params)


def register_env(name: str, module: str, class_name: str):
    """Extension hook for user environments."""
    _ENV_REGISTRY[name] = (module, class_name)
