"""Image files for the inference CLI: PNG read and written with ``zlib``
and numpy, other formats through PIL where it is installed.

JAX counterpart: ``onedc_tpu/data/datasets.py`` (``load_image`` :37,
``save_image`` :46, ``ImageFolderDataset`` :119), which go through PIL
for every format. The card's machine has no PIL, and the datasets the
CLI runs on (Kodak) are PNG, so the port reads and writes PNG itself:
8-bit gray, RGB and RGBA, not interlaced, every row filter on read,
filter 0 on write. Any other file, or another PNG variant (palette,
16-bit, gray + alpha, interlaced), goes through PIL if it can be
imported and raises, naming the file, if not. Scaling to [-1, 1] is the
JAX package's.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types read here
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


class _Unsupported(Exception):
    """A valid PNG of a variant this reader leaves to PIL."""


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _paeth_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out


def _average_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 255
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path
              ) -> np.ndarray:
    """The decompressed scanlines -> (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {len(raw)} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 3:  # Average
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif kind == 4:  # Paeth
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _read_png(path) -> np.ndarray:
    """A PNG file -> (H, W, C) uint8, C = 1 (gray), 3 (RGB) or 4 (RGBA);
    _Unsupported for a file that is not a PNG or another PNG variant."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise _Unsupported
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise _Unsupported
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch,
                       ch, path)
    return pixels.reshape(height, width, ch)


def png_bytes(pixels: np.ndarray, what="image") -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1, 3, 4 -> the bytes of a PNG file
    (filter 0)."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, ch = pixels.shape
    if pixels.dtype != np.uint8 or ch not in _COLOR_TYPE:
        raise ValueError(f"{what}: write_png takes uint8 with 1, 3 or 4 "
                         f"channels, got {pixels.dtype} {pixels.shape}")
    rows = np.zeros((h, w * ch + 1), np.uint8)
    rows[:, 1:] = pixels.reshape(h, w * ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path, pixels: np.ndarray) -> None:
    """(H, W) or (H, W, C) uint8, C in 1, 3, 4 -> a PNG file (filter 0)."""
    data = png_bytes(pixels, path)
    with open(path, "wb") as f:
        f.write(data)


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def load_image(path) -> np.ndarray:
    """An image file -> (H, W, 3) f32 in [-1, 1]: gray is repeated over
    the three channels, alpha dropped, as PIL's ``convert("RGB")``
    does."""
    try:
        arr = _read_png(path)
        arr = np.repeat(arr, 3, axis=2) if arr.shape[2] == 1 else arr[..., :3]
    except _Unsupported:
        image = _pil_image()
        if image is None:
            raise ValueError(f"{path}: not a PNG this reader takes, and PIL "
                             f"is not installed") from None
        arr = np.asarray(image.open(path).convert("RGB"))
    return arr.astype(np.float32) / 127.5 - 1.0


def save_image(arr: np.ndarray, path) -> None:
    """(H, W, 3) float in [-1, 1] -> an 8-bit image file (PNG by its own
    writer, another suffix through PIL)."""
    arr = np.clip((arr + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
    if Path(path).suffix.lower() == ".png":
        write_png(path, arr)
        return
    image = _pil_image()
    if image is None:
        raise ValueError(f"{path}: only PNG is written without PIL")
    image.fromarray(arr).save(path)


class ImageFolderDataset:
    """Every image under a folder, sorted by path: items ``{"image": (H, W,
    3) f32 in [-1, 1], "caption": "", "name": file stem}``, the image
    through ``transform`` if one is given."""

    def __init__(self, root, transform: Optional[Callable] = None):
        self.paths: List[Path] = sorted(
            p for p in Path(root).rglob("*") if p.suffix.lower() in IMG_EXTS)
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        arr = load_image(self.paths[i])
        if self.transform:
            arr = self.transform(arr)
        return {"image": arr, "caption": "", "name": self.paths[i].stem}
