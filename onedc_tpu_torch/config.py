"""YAML configs with dotted overrides, and ``target:`` instantiation.

JAX counterpart: ``onedc_tpu/config.py`` (``Config`` :18, ``load_yaml``,
``merge``, ``parse_cli_overrides`` :84, ``load_config`` :103,
``instantiate`` :108). The loaders return plain nested dicts here;
``Config.wrap`` gives one the JAX package's attribute access.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any, Iterable, Mapping, Optional, Union

import yaml


class Config(dict):
    """A dict with attribute access, wrapped recursively (nested mappings
    become ``Config``s, lists are walked)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, Mapping):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        """self["a"]["b"] = value for dotted "a.b", making ``Config``s on
        the way; the value wrapped."""
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if not isinstance(node.get(part), Mapping):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = Config.wrap(value)


def instantiate(spec: Mapping, **extra_kwargs: Any) -> Any:
    """The object of a ``{"target": "pkg.mod.Cls", "params": {...}}``
    spec, ``extra_kwargs`` over its params."""
    module_name, _, attr = spec["target"].rpartition(".")
    cls = getattr(importlib.import_module(module_name), attr)
    params = dict(spec.get("params") or {})
    params.update(extra_kwargs)
    return cls(**params)


def load_yaml(path) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def set_path(cfg: dict, dotted: str, value: Any) -> None:
    """cfg["a"]["b"] = value for dotted "a.b", making the dicts on the way."""
    *parents, leaf = dotted.split(".")
    node = cfg
    for part in parents:
        if not isinstance(node.get(part), dict):
            node[part] = {}
        node = node[part]
    node[leaf] = value


def merge(base: Mapping, override: Mapping) -> dict:
    """Recursive merge; values in ``override`` win."""
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if isinstance(out.get(k), Mapping) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_cli_overrides(args: Iterable[str]) -> dict:
    """``key.path=value`` tokens -> nested dict; values typed by YAML, and
    a string that reads as a float ("1e-4", which YAML 1.1 leaves a
    string) becomes one."""
    cfg: dict = {}
    for token in args:
        if "=" not in token:
            raise ValueError(f"override must look like key=value, got "
                             f"{token!r}")
        key, raw = token.split("=", 1)
        value = yaml.safe_load(raw)
        if isinstance(value, str):
            try:
                value = float(value)
            except ValueError:
                pass
        set_path(cfg, key.lstrip("-"), value)
    return cfg


def load_config(path: Optional[Any] = None,
                overrides: Union[Mapping[str, Any], Iterable[str]] = ()
                ) -> dict:
    """The YAML file at ``path`` (or an empty config) with ``overrides``
    on top: a mapping of dotted keys to values, or ``key.path=value``
    command-line tokens (``parse_cli_overrides``)."""
    cfg = load_yaml(path) if path else {}
    if isinstance(overrides, Mapping):
        for key, value in overrides.items():
            set_path(cfg, key, value)
        return cfg
    return merge(cfg, parse_cli_overrides(overrides))
