"""YAML configs with dotted overrides.

JAX counterpart, copied in what the trainer and the inference CLI need:
``onedc_tpu/config.py`` (``load_yaml``, ``set_path``, ``merge``,
``parse_cli_overrides`` :84, ``load_config`` :103). Configs are plain
nested dicts here.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Mapping, Optional, Union

import yaml


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
