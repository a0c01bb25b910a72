"""YAML -> ConfigNode attribute tree with ``_target_`` instantiation (counterpart of
``automodel_tpu/config/loader.py``).

- ``load_config(path)`` parses YAML into a :class:`ConfigNode` with attribute access,
  dotted ``get("a.b.c")``, ``to_dict()`` and containment checks.
- ``_target_:`` names a dotted callable; ``node.instantiate(**overrides)`` calls it
  with the node's other keys. A target under ``automodel_tpu.`` maps to the same path
  under ``automodel_tpu_torch.``, so the repository's YAMLs run unchanged; a target
  the port does not have raises, and the JAX package is never imported.
- Keys ending in ``_fn`` whose value is a dotted path resolve to the function object.
- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` interpolation is deferred until access.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any, Iterator

import yaml

__all__ = ["ConfigNode", "instantiate", "load_config", "map_target", "resolve_target",
           "translate_value"]

_ENV_RE = re.compile(r"\$\{oc\.env:([A-Za-z_][A-Za-z0-9_]*)(?:[,|]([^}]*))?\}")

# Python literals that YAML may hand us as strings from CLI overrides.
_BOOL = {"true": True, "false": False, "True": True, "False": False}


def translate_value(s: str) -> Any:
    """Best-effort convert a CLI-override string to a Python value."""
    if not isinstance(s, str):
        return s
    if s in _BOOL:
        return _BOOL[s]
    if s.lower() in ("none", "null"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if (s.startswith("[") and s.endswith("]")) or (s.startswith("{") and s.endswith("}")):
        try:
            return yaml.safe_load(s)
        except yaml.YAMLError:
            pass
    return s


def _resolve_env(value: str) -> str:
    """Expand ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` in a string."""

    def repl(m: re.Match) -> str:
        var, default = m.group(1), m.group(2)
        if var in os.environ:
            return os.environ[var]
        if default is not None:
            return default
        raise KeyError(f"environment variable {var!r} is not set and has no default")

    return _ENV_RE.sub(repl, value)


_JAX_PACKAGE = "automodel_tpu"
_PORT_PACKAGE = "automodel_tpu_torch"


def map_target(path: str) -> str:
    """``automodel_tpu.x.y`` -> ``automodel_tpu_torch.x.y``; other paths unchanged."""
    path = path.replace(":", ".")
    root, _, rest = path.partition(".")
    if root == _JAX_PACKAGE:
        return f"{_PORT_PACKAGE}.{rest}" if rest else _PORT_PACKAGE
    return path


def resolve_target(path: str) -> Any:
    """Import a dotted path ``pkg.mod.attr`` (also ``pkg.mod:attr``) to an object,
    after :func:`map_target`."""
    mapped = map_target(path)
    parts = mapped.split(".")
    last_err: Exception | None = None
    for i in range(len(parts), 0, -1):
        mod_name = ".".join(parts[:i])
        try:
            obj = importlib.import_module(mod_name)
        except ImportError as e:
            last_err = e
            continue
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError as e:
            raise ImportError(_missing(path, mapped, e)) from e
        return obj
    raise ImportError(_missing(path, mapped, last_err))


def _missing(path: str, mapped: str, err: Exception | None) -> str:
    if mapped != path.replace(":", "."):
        return (f"_target_ {path!r} maps to {mapped!r}, which the PyTorch package does not "
                f"provide yet (see ROADMAP.md): {err}")
    return f"cannot resolve _target_ {path!r}: {err}"


def _is_dotted_path(value: Any) -> bool:
    return isinstance(value, str) and bool(re.fullmatch(r"[A-Za-z_][\w\.]*[\w]", value)) and "." in value


class ConfigNode:
    """Attribute-access view over a nested dict parsed from YAML."""

    def __init__(self, data: dict[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return [cls._wrap(x) for x in v]
        return v

    @staticmethod
    def _unwrap(v: Any, resolve_env: bool = True) -> Any:
        if isinstance(v, ConfigNode):
            return v.to_dict(resolve_env=resolve_env)
        if isinstance(v, list):
            return [ConfigNode._unwrap(x, resolve_env) for x in v]
        if resolve_env and isinstance(v, str):
            return _resolve_env(v)
        return v

    # -- mapping protocol ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            v = self._data[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r} (available: {list(self._data)})")
        if isinstance(v, str):
            return _resolve_env(v)
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self.__getattr__(name)

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(value)

    def __contains__(self, name: str) -> bool:
        if "." in name:
            return self.get(name, _MISSING) is not _MISSING
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict(resolve_env=False) == other.to_dict(resolve_env=False)
        if isinstance(other, dict):
            return self.to_dict(resolve_env=False) == other
        return NotImplemented

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self.__getattr__(k)) for k in self._data]

    def values(self):
        return [self.__getattr__(k) for k in self._data]

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path get: ``cfg.get("model.pretrained_model_name_or_path")``."""
        node: Any = self
        for part in key.split("."):
            if isinstance(node, ConfigNode) and part in node._data:
                node = node.__getattr__(part)
            else:
                return default
        return node

    def set_by_path(self, path: str, value: Any) -> None:
        """Dotted-path set, creating intermediate nodes (CLI override support)."""
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], ConfigNode):
                node._data[part] = ConfigNode()
            node = node._data[part]
        node._data[parts[-1]] = self._wrap(value)

    def to_dict(self, resolve_env: bool = True) -> dict[str, Any]:
        return {k: self._unwrap(v, resolve_env) for k, v in self._data.items()}

    @property
    def raw_dict(self) -> dict[str, Any]:
        """Config as plain dict with env interpolations left unresolved (secret-safe)."""
        return self.to_dict(resolve_env=False)

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict(resolve_env=False)!r})"

    def __deepcopy__(self, memo):
        import copy

        return ConfigNode(copy.deepcopy(self.to_dict(resolve_env=False), memo))

    # -- instantiation ------------------------------------------------------
    def instantiate(self, *args: Any, **overrides: Any) -> Any:
        return instantiate(self, *args, **overrides)


_MISSING = object()


def _materialize(value: Any) -> Any:
    """Recursively instantiate nested ``_target_`` nodes and resolve ``*_fn`` paths."""
    if isinstance(value, ConfigNode):
        if "_target_" in value:
            return instantiate(value)
        return value
    if isinstance(value, list):
        return [_materialize(v) for v in value]
    return value


def instantiate(node: ConfigNode | dict, *args: Any, **overrides: Any) -> Any:
    """Instantiate ``node._target_`` with the node's keys (plus overrides) as kwargs.

    Nested nodes carrying their own ``_target_`` are instantiated depth-first.
    Keys ending in ``_fn`` whose value is a dotted path resolve to the callable itself.
    """
    if isinstance(node, dict):
        node = ConfigNode(node)
    if "_target_" not in node:
        raise ValueError(f"cannot instantiate a config without _target_: {node!r}")
    target = node.__getattr__("_target_")
    fn = resolve_target(target) if isinstance(target, str) else target

    kwargs: dict[str, Any] = {}
    for key in node:
        if key == "_target_":
            continue
        val = node.__getattr__(key)
        if isinstance(val, ConfigNode) and "_target_" in val:
            val = instantiate(val)
        elif isinstance(val, list):
            val = [_materialize(v) for v in val]
        elif key.endswith("_fn") and _is_dotted_path(val):
            val = resolve_target(val)
        kwargs[key] = val
    kwargs.update(overrides)
    return fn(*args, **kwargs)


def load_config(path: str | os.PathLike) -> ConfigNode:
    """Load a YAML file into a :class:`ConfigNode`."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise TypeError(f"top-level YAML in {path} must be a mapping, got {type(data)}")
    return ConfigNode(data)
