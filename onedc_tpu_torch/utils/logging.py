"""Logging and running means.

JAX counterpart: ``onedc_tpu/utils/logging.py`` (``get_logger`` :21,
``AvgDict`` :32); its TensorBoard writer and profiler hook wait for the
port's training loop.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Mapping


def get_logger(name: str = "onedc_tpu_torch", level=logging.INFO):
    """A logger writing to stdout, its handler added once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


class AvgDict:
    """Running means over a dict of scalars."""

    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}

    def update(self, metrics: Mapping[str, float]):
        for k, v in metrics.items():
            self._sum[k] = self._sum.get(k, 0.0) + float(v)
            self._cnt[k] = self._cnt.get(k, 0) + 1

    def mean(self) -> Dict[str, float]:
        return {k: self._sum[k] / self._cnt[k] for k in self._sum}
