"""Config system: JSON settings with "inherits_from" hierarchies.

Copy of ``icem_tpu/runtime/config.py``, which imports no JAX; the port keeps
its own, so that both packages resolve every settings file to the same dict.
Behaviorally compatible with the reference config subsystem
(reference: icem/misc/helpers.py:144-203, 246-272):

- a settings file may declare ``"inherits_from": ["defaults",
  "..defaults.i-cem-blitz", ...]`` where dotted names are relative paths
  (``a.b`` -> ``a/b.json``, a leading ``..`` walks to the parent directory)
- the inheritance DAG is walked iteratively with dedup; parents are merged
  recursively bottom-up, with entries EARLIER in an ``inherits_from`` list
  taking priority over later ones, and the child file overriding all parents
- the resolved result is frozen into an immutable, dot-accessible ParamDict
"""

from __future__ import annotations

import ast
import json
import os
import re
from collections.abc import Mapping
from copy import deepcopy
from typing import Any, Union


class ParamDict(dict):
    """An immutable dict whose elements can be accessed with a dot.

    Mirrors the reference's ParamDict semantics
    (reference: icem/misc/helpers.py:246-272).
    """

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(e)

    def __setattr__(self, key, value):
        raise TypeError("ParamDict is immutable after settings are resolved")

    def __setitem__(self, key, value):
        raise TypeError("ParamDict is immutable after settings are resolved")

    def __delattr__(self, item):
        raise TypeError("ParamDict is immutable after settings are resolved")

    def __deepcopy__(self, memo):
        return ParamDict([(deepcopy(k, memo), deepcopy(v, memo)) for k, v in self.items()])

    def __repr__(self):
        return json.dumps(self, indent=4, sort_keys=True, default=str)

    def get_pickleable(self):
        return recursive_objectify(self, make_immutable=False)


def recursive_objectify(nested: Mapping, make_immutable: bool = True):
    """Turn a nested mapping into nested ParamDicts (or plain dicts)."""
    result = dict(nested)
    for k, v in result.items():
        if isinstance(v, Mapping):
            result[k] = recursive_objectify(v, make_immutable)
    return ParamDict(result) if make_immutable else result


def update_recursive(d: dict, u: Mapping, defensive: bool = False) -> dict:
    """Deep-merge ``u`` into ``d`` in place (values in ``u`` win)."""
    for k, v in u.items():
        if defensive and k not in d:
            raise KeyError(f"Updating a non-existing key {k!r}")
        if isinstance(v, Mapping):
            d[k] = update_recursive(d.get(k, {}) if isinstance(d.get(k), dict) else {}, v)
        else:
            d[k] = v
    return d


def _inherits_to_paths(entries, base_dir: str) -> list:
    """Resolve dotted inherits_from names to absolute json paths.

    ``a.b`` -> ``a/b.json`` relative to the declaring file's directory;
    a ``..`` prefix walks up one directory (reference: helpers.py:145-154).
    """
    if entries is None:
        return []
    if not isinstance(entries, (list, tuple)):
        entries = [entries]
    paths = []
    for name in entries:
        if name is None:
            continue
        # lookahead so EVERY interior dot converts ('a.b.c' -> 'a/b/c'; the
        # reference's non-overlapping regex only got every other one)
        rel = re.sub(r"(\w)\.(?=\w)", r"\1/", str(name).replace("..", "../"))
        paths.append(os.path.normpath(os.path.join(base_dir, rel + ".json")))
    return paths


def resolve_settings(source: Union[str, Mapping], verbose: bool = False) -> ParamDict:
    """Load a settings file (or dict) and resolve its inheritance DAG.

    Merge-priority semantics match the reference resolver
    (icem/misc/helpers.py:144-193): the DAG is walked with a stack seeded with
    the root's ``inherits_from`` list; files popped later are merged later
    (and therefore override), so *earlier* entries in an ``inherits_from``
    list win over later ones, and the declaring file wins over all parents.
    """
    if isinstance(source, Mapping):
        init_params = dict(deepcopy(source))
        base_dir = os.path.dirname(os.path.abspath(init_params["default_json"])) \
            if "default_json" in init_params else os.getcwd()
    else:
        with open(source) as f:
            init_params = json.load(f)
        base_dir = os.path.dirname(os.path.abspath(source))

    hierarchy = []          # discovery order; later entries override earlier
    seen_files = [os.path.abspath(source)] if isinstance(source, str) else []
    stack = _inherits_to_paths(init_params.get("inherits_from"), base_dir)

    while stack:
        path = stack.pop()
        if path in seen_files:
            continue
        seen_files.append(path)
        with open(path) as f:
            loaded = json.load(f)
        hierarchy.append(loaded)
        parent_dir = os.path.dirname(os.path.abspath(path))
        stack.extend(_inherits_to_paths(loaded.get("inherits_from"), parent_dir))

    hierarchy.append(init_params)

    params: dict = {}
    for p in hierarchy:
        update_recursive(params, p)
    params.pop("inherits_from", None)

    resolved = recursive_objectify(params)
    if verbose:
        print(resolved)
    return resolved


def params_from_cmd_line(argv) -> ParamDict:
    """Parse argv[1] as a settings json path or a dict literal.

    Mirrors the reference's smart_settings entry (icem/misc/helpers.py:196-203);
    extra ``key=value`` args (dots for nesting) override resolved settings.
    """
    if len(argv) < 2:
        raise ValueError("usage: main.py <settings.json | {dict literal}> [key=value ...]")
    arg = argv[1]
    if os.path.isfile(arg):
        params = resolve_settings(arg)
    else:
        literal = ast.literal_eval(arg)
        if not isinstance(literal, dict):
            raise ValueError(f"cannot parse settings from {arg!r}")
        if "__import__" in str(literal):
            raise ImportError("Cannot import inside settings")
        params = resolve_settings(literal)

    if len(argv) > 2:
        params = apply_overrides(params, argv[2:])
    return params


def apply_overrides(params: ParamDict, overrides: list) -> ParamDict:
    """Apply ``a.b.c=value`` command-line overrides onto resolved params."""
    mutable = params.get_pickleable()
    for override in overrides:
        key, sep, raw = override.partition("=")
        if not sep:
            raise ValueError(f"override {override!r} must look like key=value")
        # JSON spellings first (settings files use true/false/null, and the
        # string 'false' would otherwise be truthy everywhere)
        if raw in ("true", "false", "null"):
            value = {"true": True, "false": False, "null": None}[raw]
        else:
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
        node = mutable
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return recursive_objectify(mutable)


def save_settings_to_json(params: Mapping, model_dir: str, filename: str = "settings.json"):
    """Dump resolved settings next to the run artifacts (helpers.py:206-209)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, filename), "w") as f:
        f.write(json.dumps(params, sort_keys=True, indent=4, default=str))
