"""Datasets and the host loader of the training loop.

JAX counterpart: the local-folder parts of ``onedc_tpu/data/datasets.py``
(``center_crop`` :84, ``SimpleImageText`` :141, ``ConcatDataset`` :195,
``DataLoader`` :214, ``cycle`` :250); ``ImageFolderDataset`` (:119) is
``data/images.py``'s, the crops ``data/crops.py``'s. Samples are dicts
``{"image": (H, W, 3) f32 in [-1, 1], "caption": str, "name": str}``,
batches the same keys with the images stacked (B, H, W, 3).

Not ported: ``CommonCanvasDataset`` (HF ``datasets``) and
``make_grain_loader`` (google/grain); the port depends on torch, numpy,
scipy and yaml only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from .crops import resize_if_small
from .images import ImageFolderDataset, load_image

__all__ = ["ImageFolderDataset", "SimpleImageText", "ConcatDataset",
           "DataLoader", "cycle", "center_crop"]


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
