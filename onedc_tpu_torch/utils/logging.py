"""Logging, running means, CSV reports, the run writers and the profiler
trace.

JAX counterpart: ``onedc_tpu/utils/logging.py`` (``get_logger`` :21,
``AvgDict`` :32, ``TensorboardWriter`` :53, ``WandbWriter`` :87,
``MultiWriter`` :121, ``NoOpWriter`` :148, ``make_writer`` :166,
``profile_trace`` :188). ``write_csv`` writes the reports that the JAX
package writes through pandas' ``DataFrame(rows).to_csv(index=False)``
(the card's machine has no pandas).

The trainer's writer (``make_writer``) always writes ``RunWriter``'s
files: scalars appended to ``<run_dir>/metrics.jsonl``, images as PNG
files under ``<run_dir>/images/``. Beside them, as in JAX, TensorBoard
summaries under ``<run_dir>/tb`` where the ``tensorboard`` package
imports, and wandb where ``wandb_project`` is set and the package imports
and connects; a sink that cannot open is logged once as a warning and
left out. The card's machine has neither package: there the run writes
its files only (a documented difference, ROADMAP.md Queue 3).
``profile_trace`` is the counterpart of the ``jax.profiler`` trace: a
``torch.profiler`` Chrome trace written into its directory.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch


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

    def close(self):
        """Nothing to do."""


def _unit_image(image) -> np.ndarray:
    """(H, W, 3) in [0, 1]: an image in [-1, 1] (any value below -0.01)
    scaled, then clipped, as the JAX writers do."""
    img = np.asarray(image)
    if img.min() < -0.01:
        img = img * 0.5 + 0.5
    return np.clip(img, 0, 1)


class TensorboardWriter:
    """``log_dict`` / ``log_image`` / ``log_config`` as TensorBoard
    summaries (the reference's ``WrappedTensorboard``, JAX :53-84): scalars
    tagged ``<prefix>/<key>``, images scaled to [0, 1] and stored as 8-bit
    PNG, the config as JSON text under ``config/text_summary``, the events
    and summaries ``torch.utils.tensorboard.SummaryWriter`` writes for
    ``add_scalar`` / ``add_image`` / ``add_text``. Written with the
    ``tensorboard`` package's record writer and protocol buffers alone:
    ``torch.utils.tensorboard`` imports TensorFlow wherever that is
    installed (16 s), and encodes PNG with PIL."""

    def __init__(self, log_dir):
        from tensorboard.compat.proto import event_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event_pb2 = event_pb2
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{os.uname().nodename}.{os.getpid()}.0")
        self._records = RecordWriter(open(log_dir / name, "wb"))
        self._write(event_pb2.Event(file_version="brain.Event:2"))

    def _write(self, event):
        event.wall_time = time.time()
        self._records.write(event.SerializeToString())

    def _summary(self, value, step: int):
        from tensorboard.compat.proto import summary_pb2

        self._write(self._event_pb2.Event(
            step=int(step), summary=summary_pb2.Summary(value=[value])))

    def log_dict(self, metrics: Mapping[str, float], step: int,
                 prefix: str = ""):
        from tensorboard.compat.proto.summary_pb2 import Summary

        for k, v in metrics.items():
            self._summary(Summary.Value(tag=f"{prefix}/{k}" if prefix else k,
                                        simple_value=float(v)), step)

    def log_image(self, tag: str, image: np.ndarray, step: int):
        """image: (H, W, 3) in [-1, 1] or [0, 1]."""
        from tensorboard.compat.proto.summary_pb2 import Summary

        from ..data.images import png_bytes

        pixels = (_unit_image(image).astype(np.float32) * 255).clip(
            0, 255).astype(np.uint8)
        h, w, c = pixels.shape
        self._summary(Summary.Value(tag=tag, image=Summary.Image(
            height=h, width=w, colorspace=c,
            encoded_image_string=png_bytes(pixels))), step)

    def log_config(self, config: Mapping, step: int = 0):
        from tensorboard.compat.proto import summary_pb2, tensor_pb2, \
            tensor_shape_pb2
        from tensorboard.plugins.text import plugin_data_pb2

        text = json.dumps(dict(config), indent=2, default=str)
        meta = summary_pb2.SummaryMetadata(
            plugin_data=summary_pb2.SummaryMetadata.PluginData(
                plugin_name="text", content=plugin_data_pb2.TextPluginData(
                    version=0).SerializeToString()))
        tensor = tensor_pb2.TensorProto(
            dtype="DT_STRING", string_val=[f"```\n{text}\n```".encode()],
            tensor_shape=tensor_shape_pb2.TensorShapeProto(
                dim=[tensor_shape_pb2.TensorShapeProto.Dim(size=1)]))
        self._summary(summary_pb2.Summary.Value(
            tag="config/text_summary", metadata=meta, tensor=tensor), step)

    def flush(self):
        self._records.flush()

    def close(self):
        if not self._records.closed:
            self._records.close()


class WandbWriter:
    """The same API over wandb (the reference's ``WrappedWandb``); the
    package is imported here only."""

    def __init__(self, project: str, run_name: Optional[str] = None,
                 config: Optional[Mapping] = None):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=project, name=run_name,
                              config=dict(config) if config else None)

    def log_dict(self, metrics: Mapping[str, float], step: int,
                 prefix: str = ""):
        self._wandb.log({(f"{prefix}/{k}" if prefix else k): float(v)
                         for k, v in metrics.items()}, step=step)

    def log_image(self, tag: str, image: np.ndarray, step: int):
        self._wandb.log({tag: self._wandb.Image(_unit_image(image))},
                        step=step)

    def log_config(self, config: Mapping, step: int = 0):  # noqa: ARG002
        self.run.config.update(dict(config), allow_val_change=True)

    def flush(self):
        pass

    def close(self):
        self.run.finish()


class MultiWriter:
    """One writer API fanned out to several sinks."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def log_dict(self, *a, **k):
        for w in self.writers:
            w.log_dict(*a, **k)

    def log_image(self, *a, **k):
        for w in self.writers:
            w.log_image(*a, **k)

    def log_config(self, *a, **k):
        for w in self.writers:
            w.log_config(*a, **k)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            w.close()


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

    def close(self):
        pass


# the JAX package's name for it
NoOpWriter = NullWriter


def make_writer(run_dir, wandb_project: Optional[str] = None,
                run_name: Optional[str] = None,
                enabled: Optional[bool] = None):
    """The trainer's writer into ``run_dir``: ``RunWriter``'s files, plus
    TensorBoard under ``<run_dir>/tb`` and wandb (``wandb_project``) where
    each opens, on process 0 (``enabled`` None) or where ``enabled``; a
    ``NullWriter`` elsewhere. A sink that cannot open is left out with one
    warning (JAX ``make_writer`` :178-184 does so for wandb).
    ``run_name`` (wandb's) and ``enabled`` keep JAX ``make_writer``'s
    arguments (:167-169); the trainers set neither."""
    if enabled is None:
        from ..parallel.distributed import is_main_process
        enabled = is_main_process()
    if not enabled:
        return NullWriter()
    writers = [RunWriter(run_dir)]
    try:
        writers.append(TensorboardWriter(Path(run_dir) / "tb"))
    except ImportError as e:
        get_logger().warning("tensorboard unavailable (%s); logging to "
                             "metrics.jsonl only", e)
    if wandb_project:
        try:
            writers.append(WandbWriter(wandb_project, run_name))
        except Exception as e:  # import, auth or network (no egress)
            get_logger().warning("wandb unavailable (%s); not logging to "
                                 "wandb", e)
    return writers[0] if len(writers) == 1 else MultiWriter(*writers)


@contextlib.contextmanager
def profile_trace(log_dir, enabled: bool = True):
    """``torch.profiler`` around the block (CPU, and CUDA where a card is
    present), its Chrome trace written into ``log_dir`` on exit as
    ``trace_<time>_<pid>.json`` (open in Perfetto or chrome://tracing).
    Yields the profiler (``key_averages()``, ``events()``), or None when
    not ``enabled``. The counterpart of JAX's ``jax.profiler`` trace."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(
        log_dir / f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
                  f".json"))


def read_metrics(run_dir) -> List[Dict[str, float]]:
    """The rows of ``<run_dir>/metrics.jsonl``, in order."""
    with open(Path(run_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]
