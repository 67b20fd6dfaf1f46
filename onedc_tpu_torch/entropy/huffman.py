"""Per-QP Huffman codec for VQ indices.

JAX counterpart: ``onedc_tpu/entropy/huffman.py`` (the reference's
``HuffmanCodec`` / ``HuffmanCodec_OneQP``, ``entropy_models.py:381-493``),
host numpy: a heap-built Huffman tree per probability table, with the
same deterministic tie-break (probability, then creation order) and the
same byte packing (3 bits of padding length, the codes, zero padding, big
endian), so tables and bytes equal the JAX package's. Not on the shipped
paths (the FSQ z-stream is raw 14-bit packed); part of the entropy
toolbox.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np


class _Node:
    __slots__ = ("prob", "symbol", "left", "right", "order")

    def __init__(self, prob, symbol=None, left=None, right=None, order=0):
        self.prob = prob
        self.symbol = symbol
        self.left = left
        self.right = right
        self.order = order  # the tie-break: deterministic trees

    def __lt__(self, other):
        return (self.prob, self.order) < (other.prob, other.order)


def build_code_table(probs: Sequence[float]) -> Dict[int, str]:
    """Symbol -> bit string, from a probability vector."""
    heap: List[_Node] = [_Node(float(p), symbol=i, order=i)
                         for i, p in enumerate(probs)]
    heapq.heapify(heap)
    if len(heap) == 1:
        return {heap[0].symbol: "0"}
    order = len(heap)
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        heapq.heappush(heap, _Node(a.prob + b.prob, left=a, right=b,
                                   order=order))
        order += 1
    table: Dict[int, str] = {}

    def walk(node, prefix):
        if node.symbol is not None:
            table[node.symbol] = prefix or "0"
            return
        walk(node.left, prefix + "0")
        walk(node.right, prefix + "1")

    walk(heap[0], "")
    return table


class HuffmanCodecOneQP:
    """Huffman coder of one probability table."""

    def __init__(self, probs: Sequence[float]):
        self.table = build_code_table(probs)
        self.inverse = {code: sym for sym, code in self.table.items()}
        self.max_len = max(len(c) for c in self.table.values())

    def encode(self, symbols: Sequence[int]) -> bytes:
        bits = "".join(self.table[int(s)] for s in symbols)
        # 3 bits of padding length first, so the decoder knows where to stop
        pad = (-(len(bits) + 3)) % 8
        full = format(pad, "03b") + bits + "0" * pad
        return int(full, 2).to_bytes(len(full) // 8, "big")

    def decode(self, data: bytes, count: Optional[int] = None) -> np.ndarray:
        if not data:
            return np.zeros(0, np.int32)
        bits = bin(int.from_bytes(data, "big"))[2:].zfill(len(data) * 8)
        pad = int(bits[:3], 2)
        bits = bits[3:len(bits) - pad]
        out: List[int] = []
        buf = ""
        for ch in bits:
            buf += ch
            if buf in self.inverse:
                out.append(self.inverse[buf])
                buf = ""
                if count is not None and len(out) == count:
                    break
        if buf:
            raise ValueError(f"dangling bits: {buf!r}")
        return np.asarray(out, np.int32)


class HuffmanCodec:
    """A QP-indexed family of Huffman tables (the reference's
    ``entropy_models.py:468-493``)."""

    def __init__(self):
        self._codecs: Dict[int, HuffmanCodecOneQP] = {}

    def update_vq(self, prob_tables: Dict[int, Sequence[float]]):
        for qp, probs in prob_tables.items():
            self._codecs[int(qp)] = HuffmanCodecOneQP(probs)

    def encode(self, symbols: Sequence[int], qp: int) -> bytes:
        return self._codecs[int(qp)].encode(symbols)

    def decode(self, data: bytes, qp: int,
               count: Optional[int] = None) -> np.ndarray:
        return self._codecs[int(qp)].decode(data, count)
