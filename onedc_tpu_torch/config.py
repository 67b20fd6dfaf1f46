"""YAML configs with dotted overrides.

JAX counterpart, copied in what the trainer needs:
``onedc_tpu/config.py`` (``load_yaml``, ``set_path``). Configs are plain
nested dicts here.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def load_config(path, overrides: Mapping[str, Any] = ()) -> dict:
    """The YAML file at ``path`` with each dotted key of ``overrides`` set."""
    cfg = load_yaml(path)
    for key, value in dict(overrides).items():
        set_path(cfg, key, value)
    return cfg
