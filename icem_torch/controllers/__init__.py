"""Controller registry.

Counterpart of ``icem_tpu/controllers/__init__.py``: settings files name a
controller by the same string. It holds the controllers ported so far; any
other name raises ``ImportError`` naming the known ones.
"""

from importlib import import_module

_CONTROLLER_REGISTRY = {
    "mpc-icem": ("icem_torch.controllers.icem", "MpcICem"),
}


def controller_from_string(controller_str: str):
    if controller_str not in _CONTROLLER_REGISTRY:
        raise ImportError(f"add '{controller_str}' entry to the controller registry; "
                          f"known: {sorted(_CONTROLLER_REGISTRY)}")
    module_name, class_name = _CONTROLLER_REGISTRY[controller_str]
    return getattr(import_module(module_name), class_name)

