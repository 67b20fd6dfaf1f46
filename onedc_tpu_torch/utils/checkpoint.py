"""Training checkpoints: rotating step directories and a best copy.

JAX counterpart: ``onedc_tpu/utils/checkpoint.py`` (``CKPT_PREFIX``,
``CheckpointManager`` :67-116, ``parse_step_from_path`` :119), the
reference's rotating ``checkpoint_model_{step:06d}`` directories with
``max_checkpoint`` retention and a ``checkpoints_best/`` copy at the
lowest metric.

A documented difference: the state is the port's own safetensors file
(``utils/safetensors.py``), ``state.safetensors`` in the step's
directory, not an orbax tree (the card's machine has no orbax, and
neither package reads the other's training state). The manager takes a
flat ``{name: tensor}`` and metadata strings; ``Trainer.state_tensors``
names what a trainer saves. It writes tensor by tensor (a full-width
state is ~15 GB) and restores into the live tensors in place, bit for
bit, on their device and in their dtype and layout.

The best copy hard-links the step directory's file: the files of a
checkpoint are never written again once saved, so the link is a copy that
costs no disk (a full-width copy would be another ~15 GB).

Over several processes (``parallel/distributed.py``) one file is written,
in the same layout: every rank gathers each FSDP shard (a DTensor) whole,
tensor by tensor in one loop, and process 0 writes it as it comes. A restore
reads the file on process 0 and broadcasts each tensor, and every rank
keeps its shard of it. So a checkpoint of an FSDP run resumes a run in
one process, and the reverse.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel.distributed import is_main_process, sync_global_devices, \
    world_size
from ..parallel.fsdp import local, shard_info
from .safetensors import (
    SafetensorsWriter,
    load_safetensors,
    load_safetensors_metadata,
)

CKPT_PREFIX = "checkpoint_model_"
STATE_FILE = "state.safetensors"


class CheckpointManager:
    """Rotating step checkpoints + best-by-metric dir."""

    def __init__(self, run_dir, max_checkpoints: int = 3):
        self.run_dir = Path(run_dir)
        self.best_dir = self.run_dir / "checkpoints_best"
        self.max_checkpoints = max_checkpoints
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.best_metric: Optional[float] = None

    def _step_dirs(self) -> List[Path]:
        dirs = [d for d in self.run_dir.iterdir()
                if d.is_dir() and d.name.startswith(CKPT_PREFIX)]
        return sorted(dirs, key=lambda d: int(d.name[len(CKPT_PREFIX):]))

    def save(self, tensors: Mapping[str, torch.Tensor], step: int,
             metric: Optional[float] = None,
             metadata: Optional[Mapping[str, str]] = None) -> Path:
        """Write ``tensors`` (and the ``metadata`` strings) as the
        step's checkpoint; drop the oldest beyond ``max_checkpoints``;
        make it the best copy if ``metric`` is the lowest yet."""
        path = self.run_dir / f"{CKPT_PREFIX}{step:06d}"
        main = is_main_process()
        if main:
            if path.exists():
                shutil.rmtree(path)
            path.mkdir()
        with (SafetensorsWriter(tensors, path / STATE_FILE, metadata)
              if main else contextlib.nullcontext()) as writer:
            for name in sorted(tensors):
                value = tensors[name]
                if isinstance(value, DTensor):  # an FSDP shard: every rank
                    value = value.full_tensor()  # gathers it whole
                if main:
                    writer.write(name, value)
        if not main:
            sync_global_devices("checkpoint")
            return path
        dirs = self._step_dirs()
        while len(dirs) > self.max_checkpoints:
            shutil.rmtree(dirs.pop(0))
        if metric is not None and (self.best_metric is None
                                   or metric < self.best_metric):
            self.best_metric = metric
            if self.best_dir.exists():
                shutil.rmtree(self.best_dir)
            shutil.copytree(path, self.best_dir, copy_function=os.link)
        sync_global_devices("checkpoint")
        return path

    def latest_step(self) -> Optional[int]:
        """The newest checkpoint's step (process 0's, on every rank)."""
        dirs = self._step_dirs() if is_main_process() else []
        step = int(dirs[-1].name[len(CKPT_PREFIX):]) if dirs else None
        return _from_main(step)

    def restore(self, target: Mapping[str, torch.Tensor],
                step: Optional[int] = None
                ) -> Tuple[Dict[str, str], int]:
        """Copy the checkpoint of ``step`` (None: the latest) into the
        tensors of ``target`` in place; (its metadata, the step). The
        checkpoint must hold exactly ``target``'s names, shapes and
        dtypes."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.run_dir}")
        path = self.run_dir / f"{CKPT_PREFIX}{step:06d}" / STATE_FILE
        saved, error = {}, None
        if is_main_process():
            saved = load_safetensors(path)
            error = _mismatch(path, saved, target)
        error = _from_main(error)
        if error is not None:
            raise error
        for name in sorted(target):
            dst = target[name]
            src = _from_main_tensor(saved.get(name), dst)
            with torch.no_grad():
                info = shard_info(dst)
                if info is not None:
                    mesh = dst.device_mesh
                    src = src.chunk(mesh.size(), info[0])[
                        mesh.get_local_rank()]
                local(dst).copy_(src)
        meta = (load_safetensors_metadata(path) if is_main_process()
                else None)
        return _from_main(meta), step


def _mismatch(path, saved: Mapping[str, torch.Tensor],
              target: Mapping[str, torch.Tensor]) -> Optional[Exception]:
    """The error of a checkpoint that does not hold exactly ``target``'s
    names, shapes and dtypes, else None."""
    if set(saved) != set(target):
        return KeyError(f"{path}: missing "
                        f"{sorted(set(target) - set(saved))[:8]}, unexpected "
                        f"{sorted(set(saved) - set(target))[:8]}")
    for name, dst in target.items():
        src = saved[name]
        if src.dtype != dst.dtype or src.shape != dst.shape:
            return ValueError(f"{path}: {name} is {src.dtype} "
                              f"{tuple(src.shape)}, the live state "
                              f"{dst.dtype} {tuple(dst.shape)}")
    return None


def _from_main(obj):
    """Process 0's ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _from_main_tensor(src: Optional[torch.Tensor], like: torch.Tensor
                      ) -> torch.Tensor:
    """Process 0's ``src`` (the whole of ``like``'s shape and dtype) on
    every rank, on ``like``'s device."""
    if world_size() == 1:
        return src
    buf = (src.to(like.device) if is_main_process() else
           torch.empty(like.shape, dtype=like.dtype, device=like.device))
    dist.broadcast(buf, src=0)
    return buf


def parse_step_from_path(path) -> int:
    """'.../checkpoint_model_012345' -> 12345."""
    m = re.search(rf"{CKPT_PREFIX}(\d+)", str(path))
    if not m:
        raise ValueError(f"no step in checkpoint path {path}")
    return int(m.group(1))
