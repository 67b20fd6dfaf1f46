"""Software-pipelined lambda-family decode over a stream of images: the
serving schedule.

JAX counterpart: ``onedc_tpu/serving/pipeline.py`` (``DecodePrograms``
:34, ``_pad_rows`` :51, ``pipelined_decode`` :76). The four-part prior's
host rANS <-> device ping-pong cannot overlap within one image (a true data
dependency), and the device runs one queue in order, so the overlap comes
from the order of dispatch across images: the two big stages of chunk i
(x0 = codec finish + UNet, then the VAE in sub-batches) are queued between
the prior updates of later chunks. Each index fetch waits only on the small
update queued before the big stage, so the host runs chunk i+1's rANS
while the device computes chunk i's nets.

On the card the fetch is a copy into pinned memory, issued without
blocking right after the update that produced the indexes, plus a CUDA
event recorded behind it; the worker thread waits on that event, never on
the device as a whole (``.cpu()`` or a synchronise would wait for the big
stage queued behind the update as well). Every program and every upload
is issued by the calling thread, on its current stream: the workers only
wait, run the native rANS decode (a ctypes call, which releases the GIL)
and narrow the symbols. Uploads go through pinned memory without blocking.

Spans (``utils/spans.py``) mark each boundary: on the calling thread the
dispatch of each stage (``chunk.begin``, ``chunk.update``, ``chunk.x0``,
``chunk.vae``, with ``upload`` and ``fetch`` inside), the waits for a
worker (``wait.rans``) and the final ``stitch``; on a worker
``rans.decode``, naming the chunk span that submitted it.

The loop is parameterised over the device programs, so the same schedule
drives the live runtime (``models/onedc.py:OneDCRuntime.decode_batch``)
and the model-code-free bundle decoder (``serving/decoder.py``).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils import spans


class DecodePrograms(NamedTuple):
    """Device programs of the staged lambda decode (weights bound).

    begin:  z_indices (B, H/64, W/64) int32 ->
            {y_hat, means, common, z_semantic, indexes_r}
    update: 4 step programs, (y_q_r, means, y_hat, common) ->
            {y_hat, means[, indexes_r]} (the last step emits no indexes)
    x0:     (y_hat, z_semantic) -> x0 (B, 4, H/8, W/8)
    vae:    x0 -> image (B, 3, H, W)
    """

    begin: Callable[[Any], Dict[str, Any]]
    update: Sequence[Callable[[Any, Any, Any, Any], Dict[str, Any]]]
    x0: Callable[[Any, Any], Any]
    vae: Callable[[Any], Any]


def narrow_symbols(parts: np.ndarray) -> np.ndarray:
    """Ship decoded rANS symbols as int8 when they fit: halves the host ->
    device upload of the four-part loop; the update programs cast to their
    dtype either way. ``ONEDC_SYMBOL_I8=0`` keeps int16 always (JAX
    ``_narrow_symbols`` :58)."""
    if os.environ.get("ONEDC_SYMBOL_I8", "1") != "0" \
            and parts.dtype == np.int16 and parts.size \
            and parts.min() >= -128 and parts.max() <= 127:
        return parts.astype(np.int8)
    return parts


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    rem = (-arr.shape[0]) % multiple
    if rem:
        arr = np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)])
    return arr


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on the card through pinned memory,
    queued on the current stream without blocking the host."""
    with spans.span("upload"):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)


def start_fetch(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Queue the copy of a device tensor to the host; returns the function
    that waits for that copy alone (a CUDA event recorded behind it) and
    gives the array. Call the function from any thread."""
    if t.device.type != "cuda":
        return lambda: t.numpy()
    with spans.span("fetch"):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def wait():
        done.synchronize()
        return host.numpy()
    return wait


class _ChunkSM:
    """The four-part prior loop of one chunk, one step at a time. The index
    fetch and the rANS decode run as a future on a worker: with one future
    per chunk in flight, the waits for the device run concurrently and the
    calling thread only dispatches. ``sched``: the schedule's programs,
    shapes and queues (``pipelined_decode``). A module-level class, not one
    made per call: a class object sits in a reference cycle, and one made
    inside ``pipelined_decode`` would hold the programs, and with them the
    runtime and its weights, until the collector runs."""

    def __init__(sm, sched, ci, cd, workers):
        sm.sched, sm.ci, sm.workers, sm.n = sched, ci, workers, len(cd)
        with spans.span("chunk.begin"):
            z_indices = _pad_rows(np.stack([
                np.asarray(sched.unpack_z(d["bit_stream_z"])).reshape(
                    sched.zh, sched.zw) for d in cd]), sched.mult)
            sm.n_rows = z_indices.shape[0]
            sm.coders = sched.make_coders([d["bit_stream_y"] for d in cd])
            st = sched.programs.begin(upload(z_indices, sched.device))
            sm.y_hat, sm.means = st["y_hat"], st["means"]
            sm.common, sm.z_semantic = st["common"], st["z_semantic"]
            sm.step = 0
            sm._issue(st["indexes_r"])

    def _issue(sm, idx_dev):
        fetch = start_fetch(idx_dev)
        coders, n, n_rows, narrow = (sm.coders, sm.n, sm.n_rows,
                                     sm.sched.narrow)
        cause = spans.here()

        def work():
            idx = fetch()
            # one native call decodes the whole chunk's streams; padding
            # rows (no coder) get zero symbols
            with spans.span("rans.decode", parent=cause):
                parts = type(coders[0]).decode_streams_with_indexes(
                    coders, idx[:n].reshape(n, -1)).reshape(idx[:n].shape)
            if n_rows > n:
                parts = np.concatenate(
                    [parts, np.zeros_like(idx[n:], dtype=parts.dtype)])
            return narrow(parts)

        sm.fut = sm.workers.submit(work)

    def ready(sm):
        return sm.fut.done()

    def advance(sm):
        """Run one prior step; True while more steps remain."""
        sched = sm.sched
        with spans.span("wait.rans"):
            symbols = sm.fut.result()
        with spans.span("chunk.update"):
            parts = upload(symbols, sched.device)
            nxt = sched.programs.update[sm.step](parts, sm.means, sm.y_hat,
                                                 sm.common)
            sm.y_hat, sm.means = nxt["y_hat"], nxt["means"]
            sm.step += 1
            if sm.step < 4:
                sm._issue(nxt["indexes_r"])
                return True
        sched.pending.append(sched.mk_x0(sm.ci, sm.y_hat, sm.z_semantic))
        bounds = list(range(0, sm.n_rows, sched.vae_chunk))
        for pi, lo in enumerate(bounds):
            sched.pending.append(sched.mk_vae(
                sm.ci, pi, lo, min(lo + sched.vae_chunk, sm.n_rows),
                len(bounds)))
        return False


def pipelined_decode(programs: DecodePrograms, make_coders, unpack_z,
                     decs, zh: int, zw: int, device, *, mult: int = 1,
                     chunk: Optional[int] = None,
                     depth: Optional[int] = None,
                     vae_chunk: Optional[int] = None,
                     narrow: Callable = narrow_symbols) -> torch.Tensor:
    """Decode one same-padded-size bucket of containers, pipelined.

    ``decs``: framing dicts (``entropy/framing.decode_i``) with
    ``bit_stream_z`` / ``bit_stream_y``. ``make_coders(streams)`` builds
    one host rANS coder per stream (its class exposes
    ``decode_streams_with_indexes``). ``unpack_z(bytes)`` unpacks one
    z stream to ``zh * zw`` FSQ indices. ``mult``: every chunk pads to a
    multiple of it (a bundle's fixed batch); padding rows decode zero
    symbols and are trimmed. Returns the padded images of all streams in
    order, (N, 3, H, W), in the vae program's dtype.

    Knobs, with the JAX package's defaults:
    - ONEDC_PIPELINE_CHUNK (8): images per prior-loop batch;
    - ONEDC_PIPELINE_DEPTH (3): chunks in flight, whose prior loops
      advance in lockstep so that one chunk's index fetch completes while
      the host runs the others' rANS;
    - ONEDC_VAE_CHUNK (8): the VAE stage's sub-batch, which bounds the
      peak activation memory while the prior / UNet chunk runs larger.
    """
    if chunk is None:
        chunk = int(os.environ.get("ONEDC_PIPELINE_CHUNK", "8"))
    if depth is None:
        depth = max(1, int(os.environ.get("ONEDC_PIPELINE_DEPTH", "3")))
    if vae_chunk is None:
        vae_chunk = max(1, int(os.environ.get("ONEDC_VAE_CHUNK", "8")))
    device = torch.device(device)

    chunks = [decs[i:i + chunk] for i in range(0, len(decs), chunk)]
    pending: deque = deque()
    x0s: Dict[int, Any] = {}
    vae_parts: Dict[int, dict] = {}
    outs: Dict[int, Any] = {}

    def mk_x0(ci, y_hat, z_sem):
        def f():
            with spans.span("chunk.x0"):
                x0s[ci] = programs.x0(y_hat, z_sem)
        return f

    def mk_vae(ci, pi, lo, hi, nparts):
        def f():
            with spans.span("chunk.vae"):
                part = programs.vae(x0s[ci][lo:hi])
                vae_parts.setdefault(ci, {})[pi] = part
                if len(vae_parts[ci]) == nparts:
                    parts = vae_parts.pop(ci)
                    x0s.pop(ci)
                    outs[ci] = (parts[0] if nparts == 1 else
                                torch.cat([parts[i] for i in range(nparts)]))
        return f

    sched = SimpleNamespace(
        programs=programs, make_coders=make_coders, unpack_z=unpack_z,
        zh=zh, zw=zw, device=device, mult=mult, vae_chunk=vae_chunk,
        narrow=narrow, pending=pending, mk_x0=mk_x0, mk_vae=mk_vae)

    with ThreadPoolExecutor(max_workers=depth) as workers:
        todo = deque(enumerate(chunks))
        live: deque = deque()
        while todo or live:
            while todo and len(live) < depth:
                live.append(_ChunkSM(sched, *todo.popleft(), workers))
            # prefer a chunk whose symbols are decoded; while none is,
            # keep the device fed with a big stage, then block on the
            # oldest
            sm = next((s for s in live if s.ready()), None)
            if sm is None and pending:
                pending.popleft()()
                sm = next((s for s in live if s.ready()), None)
            if sm is None:
                sm = live[0]
            live.remove(sm)
            more = sm.advance()
            # one big stage of an earlier chunk rides behind each small
            # update: the next fetch waits only on the update, and the
            # workers' rANS overlaps the big stage
            if pending:
                pending.popleft()()
            if more:
                live.append(sm)
        while pending:
            pending.popleft()()
    # trim each chunk's padding rows before stitching
    with spans.span("stitch"):
        return torch.cat([outs[ci][:len(chunks[ci])]
                          for ci in range(len(chunks))])
