"""Controller registry.

Counterpart of ``icem_tpu/controllers/__init__.py``: settings files name a
controller by the same string; any other name raises ``ImportError`` naming
the known ones.
"""

from importlib import import_module

_CONTROLLER_REGISTRY = {
    "mpc-icem": ("icem_torch.controllers.icem", "MpcICem"),
    "mpc-cem-std": ("icem_torch.controllers.cem_std", "MpcCemStd"),
    "mpc-random": ("icem_torch.controllers.random", "MpcRandom"),
    "random": ("icem_torch.controllers.random", "RndController"),
    "open-loop": ("icem_torch.controllers.open_loop", "OpenLoopPolicy"),
}


def controller_from_string(controller_str: str):
    if controller_str not in _CONTROLLER_REGISTRY:
        raise ImportError(f"add '{controller_str}' entry to the controller registry; "
                          f"known: {sorted(_CONTROLLER_REGISTRY)}")
    module_name, class_name = _CONTROLLER_REGISTRY[controller_str]
    return getattr(import_module(module_name), class_name)


def register_controller(name: str, module: str, class_name: str):
    """Extension hook for user controllers."""
    _CONTROLLER_REGISTRY[name] = (module, class_name)
