"""Logging, running means and CSV reports.

JAX counterpart: ``onedc_tpu/utils/logging.py`` (``get_logger`` :21,
``AvgDict`` :32); its TensorBoard writer and profiler hook wait for the
port's training loop. ``write_csv`` writes the reports that the JAX
package writes through pandas' ``DataFrame(rows).to_csv(index=False)``
(the card's machine has no pandas).
"""

from __future__ import annotations

import csv
import logging
import sys
from typing import Dict, Iterable, List, Mapping, Optional, Sequence


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


def first_appearance(rows: Iterable[Mapping]) -> List[str]:
    """The keys of ``rows`` in order of first appearance: the columns of
    pandas' ``DataFrame(rows)``."""
    cols: List[str] = []
    for row in rows:
        cols += [k for k in row if k not in cols]
    return cols


def write_csv(path, rows: Sequence[Mapping],
              columns: Optional[Sequence[str]] = None) -> None:
    """``rows`` as a CSV file with a header, as pandas'
    ``DataFrame(rows).to_csv(index=False)`` writes them: the columns
    ``first_appearance(rows)`` unless given, a key a row lacks an empty
    field."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=list(columns or first_appearance(rows)),
            restval="")
        writer.writeheader()
        writer.writerows(rows)
