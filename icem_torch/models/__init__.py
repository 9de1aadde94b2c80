"""Forward-model registry.

Counterpart of ``icem_tpu/models/__init__.py``: settings files name a model
by the same string; any other name raises ``ImportError`` naming the known
ones.
"""

from importlib import import_module

_MODEL_REGISTRY = {
    "GroundTruthModel": ("icem_torch.models.ground_truth", "GroundTruthModel"),
    "ParallelGroundTruthModel": ("icem_torch.models.ground_truth", "ParallelGroundTruthModel"),
    "EnsembleModel": ("icem_torch.models.ensemble", "EnsembleModel"),
    "RSSM": ("icem_torch.models.rssm", "RSSMModel"),
}


def forward_model_from_string(model_str: str):
    if model_str not in _MODEL_REGISTRY:
        raise ImportError(f"add '{model_str}' entry to the model registry; "
                          f"known: {sorted(_MODEL_REGISTRY)}")
    module_name, class_name = _MODEL_REGISTRY[model_str]
    return getattr(import_module(module_name), class_name)

