"""Environment registry.

Counterpart of ``icem_tpu/envs/__init__.py``: registry strings resolve to the
same environments, so settings files name them unchanged. It holds the envs
ported; any other name raises ``ImportError`` naming the known ones.
"""

from importlib import import_module

_ENV_REGISTRY = {
    # classic control
    "DiscreteMountainCar": ("icem_torch.envs.classic", "DiscreteActionMountainCar"),
    "DiscreteCartPole": ("icem_torch.envs.classic", "DiscreteActionCartPole"),
    "ContinuousMountainCar": ("icem_torch.envs.classic", "ContinuousMountainCar"),
    "ContinuousPendulum": ("icem_torch.envs.classic", "ContinuousPendulum"),
    "ContinuousLunarLander": ("icem_torch.envs.lander", "ContinuousLunarLander"),
    # locomotion
    "HalfCheetah": ("icem_torch.envs.cheetah", "HalfCheetah"),
    "Hopper": ("icem_torch.envs.hopper", "Hopper"),
    "Reacher": ("icem_torch.envs.reacher", "Reacher"),
    "Ant": ("icem_torch.envs.ant3d", "Ant3D"),
    "PlanarAnt": ("icem_torch.envs.ant", "Ant"),
    "HumanoidStandup": ("icem_torch.envs.humanoid3d", "HumanoidStandup3D"),
    "Humanoid": ("icem_torch.envs.humanoid3d", "Humanoid3D"),
    "PlanarHumanoidStandup": ("icem_torch.envs.humanoid", "HumanoidStandup"),
    "PlanarHumanoid": ("icem_torch.envs.humanoid", "Humanoid"),
    # goal-conditioned manipulation
    "FetchPickAndPlace": ("icem_torch.envs.fetch", "FetchPickAndPlace"),
    "FetchReach": ("icem_torch.envs.fetch", "FetchReach"),
    # dm-suite flavors
    "cartpole": ("icem_torch.envs.dm_suite", "CartPoleSuite"),
    "reacher": ("icem_torch.envs.dm_suite", "ReacherSuite"),
    "restricted_reacher": ("icem_torch.envs.dm_suite", "RestrictedReacherSuite"),
    "point_mass": ("icem_torch.envs.dm_suite", "DoubleIntSuite"),
    "restricted_point_mass": ("icem_torch.envs.dm_suite", "RestrictedDoubleIntSuite"),
    "cheetah": ("icem_torch.envs.dm_suite", "HalfCheetahSuite"),
    "swimmer": ("icem_torch.envs.dm_suite", "SwimmerSuite"),
    # Adroit hand manipulation
    "Door": ("icem_torch.envs.adroit", "Door"),
    "Relocate": ("icem_torch.envs.adroit", "Relocate"),
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
