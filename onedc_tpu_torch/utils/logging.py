"""Logging, running means and CSV reports.

JAX counterpart: ``onedc_tpu/utils/logging.py`` (``get_logger`` :21,
``AvgDict`` :32, the writers' ``log_dict`` / ``log_image`` /
``log_config`` / ``flush`` API and ``make_writer`` :166). ``write_csv``
writes the reports that the JAX package writes through pandas'
``DataFrame(rows).to_csv(index=False)`` (the card's machine has no
pandas).

A documented difference: the trainer's writer (``RunWriter``) appends
scalars to ``<run_dir>/metrics.jsonl`` and writes images as PNG files
under ``<run_dir>/images/``, where the JAX package writes TensorBoard
summaries (and wandb where configured): the card's machine has neither
tensorboard nor wandb. A config that names a wandb project raises; the
writer picks no other sink.
"""

from __future__ import annotations

import csv
import json
import logging
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np


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


class RunWriter:
    """The trainer's ``log_dict`` / ``log_image`` / ``log_config`` /
    ``flush`` over files in ``run_dir``: one JSON line per ``log_dict``
    call in ``metrics.jsonl`` (``{"step": N, "<prefix>/<key>": value,
    ...}``), images as ``images/<tag>_<step:06d>.png`` (``/`` in a tag
    becomes ``_``), the config as ``config.json``."""

    def __init__(self, run_dir):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)

    def log_dict(self, metrics: Mapping[str, float], step: int,
                 prefix: str = ""):
        row = {"step": int(step)}
        row.update({(f"{prefix}/{k}" if prefix else k): float(v)
                    for k, v in metrics.items()})
        with open(self.run_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")

    def log_image(self, tag: str, image: np.ndarray, step: int):
        """image: (H, W, 3) in [-1, 1] or [0, 1], as the JAX writers take
        it (values below -0.01 mean [-1, 1])."""
        from ..data.images import save_image

        img = np.asarray(image, np.float32)
        if img.min() >= -0.01:  # [0, 1] -> [-1, 1], save_image's range
            img = img * 2.0 - 1.0
        out = self.run_dir / "images"
        out.mkdir(exist_ok=True)
        save_image(np.clip(img, -1.0, 1.0),
                   out / f"{tag.replace('/', '_')}_{int(step):06d}.png")

    def log_config(self, config: Mapping, step: int = 0):  # noqa: ARG002
        with open(self.run_dir / "config.json", "w") as f:
            json.dump(dict(config), f, indent=2, default=str)

    def flush(self):
        """Nothing to do: every call writes and closes its file."""


class NullWriter:
    """The writer of a process other than process 0: writes nothing (the
    reference's ``accelerator.is_main_process`` gate)."""

    def log_dict(self, metrics, step, prefix=""):
        pass

    def log_image(self, tag, image, step):
        pass

    def log_config(self, config, step=0):
        pass

    def flush(self):
        pass


def make_writer(run_dir, wandb_project: Optional[str] = None):
    """The trainer's writer into ``run_dir`` on process 0, a
    ``NullWriter`` on the others (JAX ``make_writer`` gates itself the
    same way); a wandb project raises (the port has no such sink)."""
    if wandb_project:
        raise ValueError(f"wandb_project={wandb_project!r}: the port logs "
                         f"to metrics.jsonl and PNG files only; unset it")
    from ..parallel.distributed import is_main_process
    return RunWriter(run_dir) if is_main_process() else NullWriter()


def read_metrics(run_dir) -> List[Dict[str, float]]:
    """The rows of ``<run_dir>/metrics.jsonl``, in order."""
    with open(Path(run_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]
