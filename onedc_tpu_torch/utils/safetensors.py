"""safetensors files read and written with numpy, ``json`` and ``struct``.

JAX counterpart: ``onedc_tpu/utils/checkpoint.py:30-60``
(``unflatten_params``, ``save_safetensors``, ``load_safetensors``),
which go through the ``safetensors`` package; the port has its own reader
and writer, since the card's machine has no such package. The port's
state dicts are flat, so the writer takes ``{name: tensor}`` as it is.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header.

``load_safetensors`` maps the file copy-on-write and returns CPU tensors
that are views of the mapping: a file of several GB is read from disk as
the tensors are used and copied at most once, by whatever conversion the
caller makes. Writing to a returned tensor never reaches the file.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype name -> torch dtype
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the data starts on this alignment, as the reference writer pads it
_ALIGN = 8


def unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"/"-joined path: leaf} -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy``, copying only an array that is not writable
    (a tensor sharing a read-only buffer is undefined behaviour once
    written, and torch warns)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _as_tensor(value: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return tensor_from_numpy(np.ascontiguousarray(value))


class SafetensorsWriter:
    """A safetensors file written tensor by tensor: the header from
    ``like`` (``{name: array or tensor}``, read for its dtypes and shapes
    only) and ``metadata`` when opened, then ``write`` for each name in
    ``names`` (name order). Tensors on the card are copied to the host one
    at a time, as they are written: a state of many GB never lies on the
    host whole. Raises ValueError for a dtype the format has no name for,
    a tensor written out of order, or one left unwritten."""

    def __init__(self, like: Mapping[str, Any], path,
                 metadata: Optional[Mapping[str, str]] = None):
        offset = 0
        header: Dict[str, Any] = {}
        if metadata:
            header["__metadata__"] = {str(k): str(v) for k, v in
                                      metadata.items()}
        self.names = sorted(like)
        for name in self.names:
            t = like[name]
            dtype = t.dtype if isinstance(t, torch.Tensor) else \
                torch.from_numpy(np.empty(0, t.dtype)).dtype
            if dtype not in _NAMES:
                raise ValueError(f"safetensors: tensor {name!r} has dtype "
                                 f"{dtype}, which the format cannot hold")
            numel = int(np.prod(t.shape, dtype=np.int64))
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            header[name] = {"dtype": _NAMES[dtype], "shape": list(t.shape),
                            "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
        self._next = 0
        blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
        blob += b" " * (-(8 + len(blob)) % _ALIGN)
        self._f = open(path, "wb")
        self._f.write(struct.pack("<Q", len(blob)))
        self._f.write(blob)

    def write(self, name: str, value: Union[np.ndarray, torch.Tensor]
              ) -> None:
        want = (self.names[self._next] if self._next < len(self.names)
                else None)
        if name != want:
            raise ValueError(f"safetensors: {name!r} written where "
                             f"{want!r} is next")
        t = _as_tensor(value)
        if t.numel():
            # raw bytes without a copy: numpy has no bfloat16, so go
            # through a same-width integer view
            self._f.write(t.reshape(-1).view(torch.uint8).numpy().data)
        self._next += 1

    def __enter__(self) -> "SafetensorsWriter":
        return self

    def __exit__(self, kind, *_) -> None:
        self._f.close()
        if kind is None and self._next != len(self.names):
            raise ValueError(f"safetensors: {self.names[self._next]!r} "
                             f"and after it never written")


def save_safetensors(tensors: Mapping[str, Union[np.ndarray, torch.Tensor]],
                     path, metadata: Optional[Mapping[str, str]] = None
                     ) -> None:
    """Write ``{name: array or tensor}`` to ``path``, tensors in name
    order, with ``metadata`` (strings) as the header's ``__metadata__``
    (``SafetensorsWriter``)."""
    with SafetensorsWriter(tensors, path, metadata) as writer:
        for name in writer.names:
            writer.write(name, tensors[name])


def _read_header(f, path) -> Tuple[int, Dict[str, Any]]:
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", head)
    return n, json.loads(f.read(n).decode("utf-8"))


def load_safetensors_metadata(path) -> Dict[str, str]:
    """The ``__metadata__`` strings of a safetensors file ({} if none)."""
    with open(path, "rb") as f:
        return dict(_read_header(f, path)[1].get("__metadata__") or {})


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """``{name: CPU tensor}`` of a safetensors file, each a view of a
    copy-on-write mapping of the file. Raises ValueError, naming the
    tensor, for an unknown dtype or offsets that do not fit the file."""
    with open(path, "rb") as f:
        n, header = _read_header(f, path)
        # ACCESS_COPY: writable pages private to this process, so
        # torch.frombuffer takes them without a warning and a write to a
        # tensor never reaches the file
        size = f.seek(0, 2)
        data = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                if size else b"")
    start = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which this reader does "
                             f"not know")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        numel = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or begin < 0 \
                or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} ({info['dtype']}, "
                             f"{shape}) does not fit its offsets "
                             f"[{begin}, {end})")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=numel,
                                     offset=start + begin).reshape(shape)
    return out
