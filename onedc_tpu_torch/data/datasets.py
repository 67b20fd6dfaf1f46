"""Datasets and the host loaders of the training loop.

JAX counterpart: ``onedc_tpu/data/datasets.py`` (``center_crop`` :84,
``SimpleImageText`` :141, ``CommonCanvasDataset`` :162, ``ConcatDataset``
:195, ``DataLoader`` :214, ``cycle`` :250, ``make_grain_loader`` :266);
``ImageFolderDataset`` (:119) is ``data/images.py``'s, the crops
``data/crops.py``'s. Samples are dicts ``{"image": (H, W, 3) f32 in
[-1, 1], "caption": str, "name": str}``, batches the same keys with the
images stacked (B, H, W, 3).

``CommonCanvasDataset`` imports HF ``datasets`` when built (the card's
machine lacks it: there it raises ``ImportError``). ``make_grain_loader``
keeps the JAX name, which the yaml's ``loader: grain`` selects, but runs
on ``torch.utils.data.DataLoader`` worker processes (grain is on neither
machine's list of the port's packages): a seeded permutation per epoch
from a ``torch.Generator``, an equal, disjoint share per rank, batches
with the remainder dropped, and ``get_state`` / ``set_state`` of the
stream's position. The order differs from grain's index shuffle (a
documented difference, ROADMAP.md Queue 3).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .crops import resize_if_small
from .images import ImageFolderDataset, load_image

__all__ = ["ImageFolderDataset", "SimpleImageText", "CommonCanvasDataset",
           "ConcatDataset", "DataLoader", "cycle", "center_crop",
           "make_grain_loader", "WorkerLoader"]


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    arr = resize_if_small(arr, size)
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


class SimpleImageText:
    """Parallel image / caption lists."""

    def __init__(self, image_paths: Sequence, captions: Sequence[str],
                 transform: Optional[Callable] = None):
        if len(image_paths) != len(captions):
            raise ValueError(f"{len(image_paths)} images for "
                             f"{len(captions)} captions")
        self.image_paths = list(image_paths)
        self.captions = list(captions)
        self.transform = transform

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        arr = load_image(self.image_paths[i])
        if self.transform:
            arr = self.transform(arr)
        return {"image": arr, "caption": self.captions[i],
                "name": Path(self.image_paths[i]).stem}


class CommonCanvasDataset:
    """CommonCanvas shards through HF ``datasets`` from local disk (a
    ``save_to_disk`` directory or one arrow file), capped at
    ``loading_length`` rows (the reference's ``common_canvas_set.py``).
    Rows decode as in JAX (:183-192): an image with ``convert`` (a PIL
    image, as ``datasets`` decodes it) through ``convert("RGB")``, else the
    array as it is; scaled to [-1, 1] in f32; the caption as a string; the
    row number as the name."""

    def __init__(self, path, split: str = "train",
                 loading_length: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 image_key: str = "jpg", caption_key: str = "blip2_caption"):
        import datasets as hf_datasets

        self.ds = (hf_datasets.load_from_disk(str(path))
                   if os.path.isdir(str(path))
                   else hf_datasets.Dataset.from_file(str(path)))
        if loading_length is not None:
            self.ds = self.ds.select(range(min(loading_length, len(self.ds))))
        self.transform = transform
        self.image_key = image_key
        self.caption_key = caption_key

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        row = self.ds[int(i)]
        img = row[self.image_key]
        if hasattr(img, "convert"):
            img = img.convert("RGB")
        arr = np.asarray(img).astype(np.float32) / 127.5 - 1.0
        if self.transform:
            arr = self.transform(arr)
        return {"image": arr, "caption": str(row.get(self.caption_key, "")),
                "name": str(i)}


class ConcatDataset:
    """Several datasets one after another."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self.offsets[k])]


class DataLoader:
    """Shuffle (by ``default_rng(seed + epoch)``), batch, stack to NHWC
    numpy. ``_skip_batches`` is consumed once, by the next ``__iter__``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._skip_batches = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        stop = n - n % bs if self.drop_last else n
        skip, self._skip_batches = self._skip_batches, 0
        for start in range(skip * bs, stop, bs):
            items = [self.dataset[int(i)] for i in order[start:start + bs]]
            yield {
                "image": np.stack([it["image"] for it in items]),
                "caption": [it["caption"] for it in items],
                "name": [it["name"] for it in items],
            }


def cycle(loader, skip: int = 0) -> Iterator:
    """Epochs of ``loader`` without end. ``skip`` fast-forwards that many
    batches without reading any data (a resumed run continues the stream
    where it stopped: only the epoch counter and the in-epoch offset
    move)."""
    if skip:
        per = len(loader)
        loader._epoch += skip // per
        loader._skip_batches = skip % per
    while True:
        for batch in loader:
            yield batch


def _collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"image": np.stack([it["image"] for it in items]),
            "caption": [it["caption"] for it in items],
            "name": [it["name"] for it in items]}


class _Batches(torch.utils.data.Sampler):
    """The batches of ``loader`` from (epoch, batch) on: lists of dataset
    indices."""

    def __init__(self, loader: "WorkerLoader", epoch: int, batch: int):
        self.loader, self.epoch, self.batch = loader, epoch, batch

    def __iter__(self):
        ld, epoch, first = self.loader, self.epoch, self.batch
        bs = ld.batch_size
        while ld.num_epochs is None or epoch < ld.num_epochs:
            share = ld.epoch_order(epoch)
            for b in range(first, ld.batches_per_epoch):
                yield share[b * bs:(b + 1) * bs].tolist()
            epoch, first = epoch + 1, 0


# seconds a worker's batch may take (a decode of one batch takes far less)
WORKER_TIMEOUT_S = 600


class WorkerLoader:
    """An iterator of batches (``DataLoader``'s shape) read by
    ``torch.utils.data.DataLoader`` worker processes, in an order that is a
    function of the seed and the stream's position alone. Epoch e is a
    permutation of the dataset (``torch.randperm`` from a generator seeded
    from the seed and e by ``numpy.random.SeedSequence``; the identity
    without ``shuffle``); rank r of w takes
    its r-th of w equal blocks of it (the remainder dropped), in batches of
    ``batch_size`` (the remainder dropped). ``get_state`` is the position
    of the next batch the caller will receive (not of what the workers
    have prefetched), the same on every rank, so one rank's state restores
    any rank's stream; ``set_state`` moves there, restarting the workers.
    ``close`` stops them. A worker's batch that takes longer than
    ``WORKER_TIMEOUT_S`` raises instead of hanging the caller."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 num_epochs: Optional[int] = None, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.num_workers = int(num_workers)
        self.num_epochs = num_epochs
        self.rank, self.world = int(rank), int(world)
        self.records = len(dataset)
        self.per_rank = self.records // self.world
        self.batches_per_epoch = self.per_rank // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(f"{self.records} records over {self.world} "
                             f"ranks make no batch of {self.batch_size}")
        self.epoch, self.batch = 0, 0
        self._it = None

    def epoch_order(self, epoch: int) -> np.ndarray:
        """This rank's share of epoch ``epoch``, in order."""
        if self.shuffle:
            # the CPU generator keeps 32 bits of its seed: mix the two
            gen = torch.Generator()
            gen.manual_seed(int(np.random.SeedSequence(
                [self.seed, int(epoch)]).generate_state(1)[0]))
            order = torch.randperm(self.records, generator=gen).numpy()
        else:
            order = np.arange(self.records)
        return order[self.rank * self.per_rank:
                     (self.rank + 1) * self.per_rank]

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        if self.num_epochs is not None and self.epoch >= self.num_epochs:
            raise StopIteration
        if self._it is None:
            self._it = iter(torch.utils.data.DataLoader(
                self.dataset, batch_sampler=_Batches(self, self.epoch,
                                                     self.batch),
                num_workers=self.num_workers, collate_fn=_collate,
                timeout=WORKER_TIMEOUT_S if self.num_workers else 0))
        out = next(self._it)
        self.batch += 1
        if self.batch == self.batches_per_epoch:
            self.epoch, self.batch = self.epoch + 1, 0
        return out

    def _identity(self) -> Dict[str, Any]:
        return {"records": self.records, "batch_size": self.batch_size,
                "seed": self.seed, "shuffle": self.shuffle,
                "ranks": self.world}

    def get_state(self) -> bytes:
        return json.dumps(dict(self._identity(), epoch=self.epoch,
                               batch=self.batch)).encode()

    def set_state(self, state: bytes) -> None:
        d = json.loads(bytes(state).decode())
        if {k: d.get(k) for k in self._identity()} != self._identity():
            raise ValueError(f"loader state of another stream: {d}, this "
                             f"loader {self._identity()}")
        self.close()
        self.epoch, self.batch = int(d["epoch"]), int(d["batch"])

    def close(self) -> None:
        """Stop the worker processes (the next batch starts new ones)."""
        it, self._it = self._it, None
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def make_grain_loader(dataset, batch_size: int, *, shuffle: bool = True,
                      seed: int = 0, num_workers: int = 8,
                      num_epochs: Optional[int] = None) -> WorkerLoader:
    """The multi-process input pipeline of ``loader: grain``: a
    ``WorkerLoader`` over this process's rank and world
    (``parallel/distributed.py``)."""
    from ..parallel.distributed import rank, world_size

    return WorkerLoader(dataset, batch_size, shuffle=shuffle, seed=seed,
                        num_workers=num_workers, num_epochs=num_epochs,
                        rank=rank(), world=world_size())
