"""The batch-decode runner: a closed loop with one caller, each call one
``OneDCRuntime.decode_batch`` of the traffic's image mix.

Set-up: the weights on the device from the seed, a pool of
``pool_calls`` calls' worth of streams (lambda: seeded images through the
program's write plan, written by the benchmark's own rANS coder; z-only:
seeded FSQ indices framed by the benchmark, a z-only stream being pure
format), ``warm_calls`` calls. The window: calls back to back, each on the
next group of the pool, to a synchronised device. Every image of
``checked_calls`` whole calls, a sample of the window's calls drawn from
the seed as they come (a reservoir), is kept on the host: each size
bucket, chunk and slot of those calls. After the window they are held
against the reference's decodes of their streams.

``--trace 1``: three calls follow the unprofiled ones, so that no call
the host's clock reads runs after a profiler session (whose clean-up slows
the next calls). The first two run under the profiler's CUDA activity and
the second is read (busy time, kernels, the window): the first pays the
profiler's start-up on the host. The third runs under its CPU activity
too (the names of the idle gaps).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..reference import decode as ref_decode
from ..reference import entropy
from ..reference import model as ref_model
from ..reference.model import OneDCDecoder
from . import seeded, trace, work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# thresholds, in units of the plain reference's own rounding error in the
# configuration's dtype, at which the share of far pixels is noted
FAR_KS = (2, 3, 4, 5, 6, 8)
# the one of them that ``far_pixel_share`` counts
FAR_K = 4
# images per write plan when the lambda pool is written
PLAN_CHUNK = 8


def calls_of(traffic: dict, seed: int):
    """``pool_calls`` lists of (h, w), each the traffic's mix of sizes in a
    seeded order."""
    sizes = [(h, w) for h, w, n in traffic["call"] for _ in range(n)]
    rng = np.random.default_rng(seed & seeded.SEED_MASK)
    return [[sizes[i] for i in rng.permutation(len(sizes))]
            for _ in range(traffic["pool_calls"])]


def build_program(cfg: dict, seed: int, device, variant=None):
    """The served runtime on the seeded weights, and the parameter shapes
    the weights were drawn for. ``variant`` "w8a8": the program's own int8
    mode, the control of a bf16 configuration."""
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime

    dtype = DTYPES[cfg["decode_dtype"]]
    with torch.device("meta"):
        model = OneDC(**cfg["model"])
    shapes = [(n, p.shape) for n, p in model.named_parameters()]
    model = model.to_empty(device=device).to(dtype)
    state = seeded.weights(shapes, seed, device, dtype,
                           cfg.get("stream_scale", 1.0))
    model.load_state_dict(state, strict=True)
    del state
    rt = OneDCRuntime(model, dtype=dtype, device=device,
                      quant="w8a8" if variant == "w8a8" else None)
    return rt, shapes


def build_reference(cfg: dict, shapes, seed: int, device, dtype=None
                    ) -> OneDCDecoder:
    """The reference on the same seeded tensors (drawn again), in float32
    or in ``dtype``."""
    with torch.device("meta"):
        ref = OneDCDecoder(cfg["model"])
    want = dict(ref.named_parameters())
    state = seeded.weights(shapes, seed, device, DTYPES[cfg["decode_dtype"]],
                           cfg.get("stream_scale", 1.0))
    ref = ref.to_empty(device=device).to(dtype or torch.float32)
    ref.load_state_dict({k: state[k] for k in want}, strict=True)
    del state
    return ref


def make_streams(rt, cfg, calls, seed, device, writer=None):
    """The pool's containers, call by call; the CDF indexes each lambda
    stream was written under ([4 arrays] per stream, None for z-only);
    the mean y-stream bpp.

    A lambda stream is written from the program's write plan
    (``OneDCRuntime.write_plan`` on seeded images, the same sizes of a call
    in chunks of ``PLAN_CHUNK``) by the benchmark's own rANS coder and framing,
    so that the indexes the reference decodes under are those the stream
    was written with. ``writer``, a reference model: the plan's indexes are
    replaced by those its prior gives the plan's symbols (the control of
    the writer's indexes)."""
    flat = [hw for call in calls for hw in call]
    n = len(calls[0])
    if cfg["model"].get("z_only"):
        zs = seeded.z_only_indices(seed, flat, 4 ** 7)
        streams = [entropy.frame(h, w, b"", entropy.pack_indices(z))
                   for (h, w), z in zip(flat, zs)]
        return ([streams[i:i + n] for i in range(0, len(streams), n)],
                [None] * len(streams), 14 / 64 ** 2)
    images = seeded.images(seed, flat, device)
    streams, indexes = [None] * len(flat), [None] * len(flat)
    for g in range(len(calls)):
        by_size = {}
        for i in range(g * n, (g + 1) * n):
            by_size.setdefault(flat[i], []).append(i)
        for (h, w), idx in by_size.items():
            for c0 in range(0, len(idx), PLAN_CHUNK):
                sel = idx[c0:c0 + PLAN_CHUNK]
                plan = rt.write_plan(torch.cat([images[i] for i in sel]))
                sym = [t.cpu().numpy() for t in plan["y_q_w"]]
                ind = [t.cpu().numpy() for t in plan["indexes_w"]]
                if writer is not None:
                    ind = ref_decode.writer_indexes(
                        writer, plan["z_indices"], plan["y_q_w"])
                z = plan["z_indices"].cpu().numpy()
                for r, i in enumerate(sel):
                    steps = [(sym[s][r:r + 1], ind[s][r:r + 1])
                             for s in range(4)]
                    streams[i] = entropy.frame(
                        h, w, entropy.encode_y(steps),
                        entropy.pack_indices(z[r:r + 1]))
                    indexes[i] = [ind[s][r:r + 1] for s in range(4)]
    bpp = float(np.mean([(len(entropy.parse(st)["y"]) * 8) / (h * w)
                         for st, (h, w) in zip(streams, flat)]))
    return ([streams[i:i + n] for i in range(0, len(streams), n)], indexes,
            bpp)


def per_image_work(cfg, calls) -> dict:
    sizes = calls[0]
    z_only = bool(cfg["model"].get("z_only"))
    out = {}
    for hw in set(sizes):
        w = work.decode_work(cfg["model"], *hw, z_only=z_only)
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v * sizes.count(hw) / len(sizes)
    return out


def run(cell, device, t_start: float, hooks=None) -> dict:
    """One run of a decode cell -> the runner's record (see ``cell.py``).
    ``hooks``: "variant" (``build_program``'s, or "fp8_writer": the pool
    written under the indexes of the reference's prior in float8), "fault"
    (a function applied to each call's images)."""
    hooks = hooks or {}
    cfg, traffic, seed = cell.config, cell.traffic, cell.seed
    variant = hooks.get("variant")
    calls = calls_of(traffic, seed)
    phases = {"start_s": time.perf_counter() - t_start}
    rt, shapes = build_program(cfg, seed, device, variant)
    cuda = device.type == "cuda"
    writer = None
    if variant == "fp8_writer" and not cfg["model"].get("z_only"):
        writer = ref_model.fp8_products(build_reference(
            cfg, shapes, seed, device, DTYPES[cfg["decode_dtype"]]))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases["weights_s"] = time.perf_counter() - t_start
    pool, indexes, bpp = make_streams(rt, cfg, calls, seed, device, writer)
    del writer
    phases["pool_s"] = time.perf_counter() - t_start
    fault = hooks.get("fault")

    def call(i):
        out = rt.decode_batch(pool[i % len(pool)])
        if fault is not None:
            out = fault(out)
        if cuda:
            torch.cuda.synchronize(device)
        return out

    for i in range(traffic["warm_calls"]):
        call(i)
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng((seed + 7) & seeded.SEED_MASK)
    n_keep, kept, durs, i = traffic["checked_calls"], [], [], 0
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        out = call(i)
        durs.append(time.perf_counter() - ta)
        # a reservoir of whole calls: each call of the window is kept with
        # the same chance, drawn from the seed
        slot = i if i < n_keep else int(rng.integers(i + 1))
        if slot < n_keep:
            host = (i, [x.detach().cpu() for x in out])
            if slot < len(kept):
                kept[slot] = host
            else:
                kept.append(host)
        del out
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= cell.seconds:
            break
    n_window, traced, gaps, windows = i, None, None, []
    if cell.trace:
        for k in range(3):
            box = []
            if k < 2:
                traced = trace.profile(lambda: box.append(call(i)), device)
                windows.append(traced.window_s)
            else:
                gaps = trace.idle_gaps(lambda: box.append(call(i)), device)
            del box
            i += 1
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_call = len(calls[0])

    # the check: every image of the kept calls against the reference
    del rt, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = build_reference(cfg, shapes, seed, device)
    same = build_reference(cfg, shapes, seed, device,
                           DTYPES[cfg["decode_dtype"]])
    worst, finite, stats, each = 0.0, True, {}, []
    for ci, images in sorted(kept, key=lambda k: k[0]):
        g = ci % len(pool)
        for j, got in enumerate(images):
            src, idx = pool[g][j], indexes[g * n_call + j]
            sym = ref_decode.y_symbols(src, idx)
            want = ref_decode.decode(ref, src, device, sym, idx, stats).cpu()
            base = ref_decode.decode(same, src, device, sym).cpu()
            finite &= bool(torch.isfinite(got).all())
            if got.shape != want.shape:
                worst = math.inf
                continue
            noise = torch.maximum((base - want).pow(2).mean().sqrt(),
                                  1e-6 * want.pow(2).mean().sqrt())
            err = (got - want).abs() / noise
            each.append({"rel_l2": ((got - want).norm()
                                    / want.norm()).item(),
                         "plain_rel_l2": ((base - want).norm()
                                          / want.norm()).item(),
                         **{f"far{t:g}": (err > t).float().mean().item()
                            for t in FAR_KS}})
            far = each[-1][f"far{FAR_K:g}"]
            worst = max(worst, far if math.isfinite(far) else math.inf)
    limits = cfg["limits"]
    checks = [("far_pixel_share", worst, limits["far_pixel_share"])]
    if stats:
        checks += [(f"index_{k}_share", stats[k] / stats["indexes"],
                    limits[f"index_{k}_share"]) for k in ("differ", "far")]
    notes = {"bpp_y": bpp, "checked_calls": sorted(k[0] for k in kept),
             "checked_images": len(each), "calls": i,
             "worst": {k: max(e[k] for e in each) for k in each[0]}
             if each else {},
             "call_s": durs, "setup_phases": phases}
    if windows:
        notes["profiled_windows_s"] = windows
    ctx = None
    if cell.trace:
        ctx = {"trace": traced, "images": n_call,
               "untraced_images": n_window * n_call,
               "untraced_s": sum(durs), "call_s": durs,
               "work": per_image_work(cfg, calls)}
    return {
        "e2e": {"decode_img_per_s": n_window * n_call / elapsed,
                "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        "checks": checks,
        "correct": finite and bool(each)
        and all(v <= lim for _, v, lim in checks),
        "attempted": i * n_call, "failed": 0, "peak_bytes": peak,
        "notes": notes, "each": each, "ctx": ctx, "idle_gaps": gaps,
    }
