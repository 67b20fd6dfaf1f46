"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit; exits non-zero without a GPU.
2. Builds the CUDA kernels (nvcc, one process per source) and the rANS
   coder (g++) from the sources in this checkout.
3. Kernel phase: each kernel against its plain PyTorch version at the
   shapes the decode path gives it, with the tolerance stated below; CUDA
   event times of the kernel, the plain version and one PyTorch library
   call for the same function; the card's bound for the same work.
4. Main path: the full-width OneDC (lambda family: codec 512/128, FSQ
   [4]*7, SD1.5 UNet, SD2.1 VAE decoder) on weights drawn from a seeded
   generator, in bf16. Writes two 768x768 streams and one 512x768 stream
   with the port's own programs (``write_synthetic_stream``), decodes each
   with ``OneDCRuntime.decode`` and all three with ``decode_batch``, and
   checks symbols, y_hat, images and kernel launch counts, and that a row
   of a batch decodes the same whatever stream shares its batch.
5. Prints ``{"kernels": [...]}`` and, last, the device line.

Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 limits of the kernel phase, against the plain version's output ref
# on the same inputs, with no absolute floor:
#   ||out - ref|| <= REL_L2_TOL * ||ref||  and
#   max|out - ref| <= MAX_TOL * max|ref|.
# Both sides round their output to bf16 (at most 2^-8 relative, so one ulp
# at the largest magnitude is <= 0.8 % of it); K1 rounds the probabilities
# to bf16 before P.V, K2 evaluates the SiLU with the fast intrinsics
# (__expf, __fdividef), and both sum in f32 in another order than the plain
# version. Each check also shows its power: the plain version with one
# 64-key tile left out (K1) or one 32-channel input chunk left out (K2),
# the work one block iteration does, must fail it.
REL_L2_TOL = 1e-2
MAX_TOL = 2e-2
# decode_batch against the single decodes. Within one bucket, each row must
# depend on its own stream only: a row decodes bit-identically whatever
# stream shares its batch (checked exactly). Against a batch-1 decode a row
# drifts: cuDNN and the GroupNorm reductions pick other kernels for a batch
# of 2 than for 1 (tools/probe_port_batch.py lists the ops), bf16 rounds
# elsewhere, x0 recovery divides by sqrt(alpha_bar(999)) ~ 0.069 and the
# random-weight VAE turns 0.2 % of noise on x0 into ~2 % in the image
# (3.1e-2 relative L2 and 3.9e-2 of max|image| measured on an H100).
# Limits: the difference's L2 norm relative to the image's, and its
# largest magnitude relative to the image's largest.
BATCH_REL_L2_TOL = 0.05
BATCH_MAX_TOL = 0.06

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, SXM data sheet
H100_HBM_BYTES = 3.35e12   # bytes/s, SXM data sheet

# shapes the decode path gives the kernels, with their launches per decode
# call of one bucket (768x768; K1 at /8 and /16, K2 in every VAE resnet);
# "batch2" checks the batch index of each kernel at one shape of the
# two-stream bucket that decode_batch runs
K1_SHAPES = {"768x768": [((1, 9216, 8, 40), 5), ((1, 2304, 8, 80), 5)],
             "512x768": [((1, 6144, 8, 40), 5)],
             "batch2": [((2, 2304, 8, 80), 5)]}
K2_SHAPES = {"768x768": [((1, 96, 96, 512, 512), 10),
                         ((1, 192, 192, 512, 512), 6),
                         ((1, 384, 384, 512, 256), 1),
                         ((1, 384, 384, 256, 256), 5),
                         ((1, 768, 768, 256, 128), 1),
                         ((1, 768, 768, 128, 128), 5)],
             "512x768": [((1, 64, 96, 512, 512), 10),
                         ((1, 128, 192, 512, 512), 6),
                         ((1, 256, 384, 512, 256), 1),
                         ((1, 256, 384, 256, 256), 5),
                         ((1, 512, 768, 256, 128), 1),
                         ((1, 512, 768, 128, 128), 5)],
             "batch2": [((2, 96, 96, 512, 512), 10)]}
K1_PER_CALL = {"768x768": 10, "512x768": 5}
K2_PER_CALL = {"768x768": 28, "512x768": 28}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# ---------------------------------------------------------------------------
# weights and streams
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_random_weights(model: torch.nn.Module, seed: int,
                        gain: float = 0.5) -> None:
    """Seeded weights in place: conv/linear weights gain * N(0, 1/fan_in),
    norm weights 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=g, device=dev,
                            dtype=torch.float32)
        if name.endswith("bias"):
            p.copy_(0.1 * noise)
        elif p.dim() == 1:  # GroupNorm / LayerNorm weight
            p.copy_(1 + 0.1 * noise)
        else:
            fan_in = p[0].numel()
            p.copy_(gain * noise / fan_in ** 0.5)


@torch.no_grad()
def write_synthetic_stream(runtime, h: int, w: int, seed: int):
    """A lambda-family container for an h x w image, written with the
    port's own decode programs (the JAX ``write_container`` order).

    z indices are drawn at random; at each of the 4 steps the symbols are
    drawn ~ round(N(0, scale_table[index])) under the step's CDF index, with
    one symbol in 500 drawn at 8x the scale so that bypass escapes occur,
    and fed to ``decompress_update`` for the next step's indexes. Returns
    (stream, y_hat of the writer, [(indexes, symbols)] per step).
    """
    from onedc_tpu_torch.entropy.coder import EntropyCoder
    from onedc_tpu_torch.entropy.framing import encode_i, get_padding_size
    from onedc_tpu_torch.entropy.gaussian import (
        GaussianConditionalCoder,
        scale_table,
    )

    rng = np.random.default_rng(seed)
    codec = runtime.model.codec
    ds = runtime.ds
    _, pr, _, pb = get_padding_size(h, w, ds)
    zh, zw = (h + pb) // ds, (w + pr) // ds
    z = rng.integers(0, codec.z_vq.codebook_size, (1, zh, zw),
                     dtype=np.int64).astype(np.int32)
    st = codec.decompress_begin(torch.from_numpy(z).to(runtime.device))
    table = scale_table()
    steps = []
    for step in range(4):
        idx = st["indexes_r"].cpu().numpy()
        sigma = table[idx.astype(np.int64)]
        sigma = np.where(rng.random(idx.shape) < 2e-3, 8 * sigma, sigma)
        sym = np.round(rng.standard_normal(idx.shape) * sigma)
        sym = np.clip(sym, -30000, 30000).astype(np.int16)
        steps.append((idx, sym))
        st.update(codec.decompress_update(
            step, torch.from_numpy(sym).to(runtime.device), st["means"],
            st["y_hat"], st["common"]))

    ec = EntropyCoder()
    gc = GaussianConditionalCoder()
    gc.update(ec)
    for idx, sym in steps:
        gc.encode_with_indexes(sym, idx)
    ec.flush()
    stream = encode_i(h, w, ec.get_encoded_stream(),
                      codec.z_vq.pack_indices(z))
    return stream, st["y_hat"], steps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def compare(name: str, out, ref, mutant) -> dict:
    """Holds ``out`` against ``ref`` within REL_L2_TOL / MAX_TOL, and checks
    that ``mutant`` (ref's function with one block iteration's work left
    out) would fail the same limits."""
    ref = ref.float()

    def errs(t):
        diff = t.float() - ref
        return ((diff.norm() / ref.norm()).item(),
                (diff.abs().max() / ref.abs().max()).item(),
                diff.abs().max().item())

    rel_l2, rel_max, max_abs = errs(out)
    m_rel_l2, m_rel_max, _ = errs(mutant)
    print(f"{name}: relative L2 {rel_l2:.3e} (tol {REL_L2_TOL}), max err "
          f"{max_abs:.3e} = {rel_max:.3e} of max|ref| (tol {MAX_TOL}); one "
          f"block step left out: {m_rel_l2:.3e}, {m_rel_max:.3e}", flush=True)
    if not (rel_l2 <= REL_L2_TOL and rel_max <= MAX_TOL):
        raise AssertionError(f"{name} disagrees with its plain version")
    if m_rel_l2 <= REL_L2_TOL and m_rel_max <= MAX_TOL:
        raise AssertionError(f"{name}: the limits cannot tell a kernel that "
                             f"skips one block step")
    return dict(max_abs_err=max_abs, rel_l2_err=rel_l2, rel_max_err=rel_max,
                mutant_rel_l2=m_rel_l2, mutant_rel_max=m_rel_max)


def check_k1(gen: torch.Generator):
    from onedc_tpu_torch.ops import flash_attention as k1

    rows = []
    for bucket, shapes in K1_SHAPES.items():
        for (b, n, h, d), count in shapes:
            q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(3))
            scale = d ** -0.5
            out = k1.flash_attention(q, k, v, scale)
            ref = k1.attention_plain(q, k, v, scale)
            mutant = k1.attention_plain(q, k[:, 64:], v[:, 64:], scale)
            errs = compare(f"K1 {bucket} {(b, n, h, d)}", out, ref, mutant)
            del ref, mutant
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ms = cuda_ms(lambda: k1.flash_attention(q, k, v, scale))
            plain = cuda_ms(lambda: k1.attention_plain(q, k, v, scale),
                            iters=3)
            lib = cuda_ms(lambda: sdpa(qt, kt, vt, scale=scale))
            bnd, by = bound_ms(4.0 * b * h * n * n * d, 4 * b * n * h * d * 2)
            rows.append(dict(bucket=bucket, shape=[b, n, h, d], count=count,
                             **errs, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bnd, bound_by=by))
            print(f"K1 {bucket} {(b, n, h, d)} x{count}: kernel {ms:.4f} ms "
                  f"plain {plain:.4f} sdpa {lib:.4f} bound {bnd:.4f} ({by})",
                  flush=True)
    return rows


def check_k2(gen: torch.Generator):
    from onedc_tpu_torch.ops import conv3x3 as k2

    rows = []
    for bucket, shapes in K2_SHAPES.items():
        for (b, hh, ww, cin, cout), count in shapes:
            x = torch.randn((b, hh, ww, cin), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            mul = 1 + 0.1 * torch.randn((b, cin), generator=gen,
                                        device="cuda")
            add = 0.1 * torch.randn((b, cin), generator=gen, device="cuda")
            w = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                 / (9 * cin) ** 0.5).to(torch.bfloat16)
            bias = (0.1 * torch.randn((cout,), generator=gen, device="cuda")
                    ).to(torch.bfloat16)
            out = k2.affine_silu_conv3x3(x, mul, add, w, bias)
            ref = k2.affine_silu_conv3x3_plain(x, mul, add, w, bias)
            w_skip = w.clone()
            w_skip[:, :, :k2.CIN_MULTIPLE] = 0  # one input chunk left out
            mutant = k2.affine_silu_conv3x3_plain(x, mul, add, w_skip, bias)
            errs = compare(f"K2 {bucket} {(b, hh, ww, cin, cout)}", out, ref,
                           mutant)
            del ref, mutant, w_skip
            t = torch.nn.functional.silu(
                x.float() * mul[:, None, None, :] + add[:, None, None, :]
            ).to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv = torch.nn.functional.conv2d
            ms = cuda_ms(lambda: k2.affine_silu_conv3x3(x, mul, add, w, bias))
            plain = cuda_ms(lambda: k2.affine_silu_conv3x3_plain(
                x, mul, add, w, bias), iters=5)
            lib = cuda_ms(lambda: conv(t, w_oihw, bias, padding=1))
            flops = 2.0 * b * hh * ww * cin * cout * 9
            nbytes = (b * hh * ww * (cin + cout) * 2 + 9 * cin * cout * 2
                      + 2 * b * cin * 4 + cout * 2)
            bnd, by = bound_ms(flops, nbytes)
            rows.append(dict(bucket=bucket, shape=[b, hh, ww, cin, cout],
                             count=count, **errs, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd, bound_by=by))
            print(f"K2 {bucket} {(b, hh, ww, cin, cout)} x{count}: kernel "
                  f"{ms:.4f} ms plain {plain:.4f} cudnn {lib:.4f} bound "
                  f"{bnd:.4f} ({by})", flush=True)
    return rows


def summarize(name, source, replaces, rows, launches):
    """One kernel's line entry: the times of one 768x768 decode call
    (sum over its shapes of count x per-launch time); ``launches`` is the
    count over the whole main-path run."""
    main = [r for r in rows if r["bucket"] == "768x768"]

    def total(key):
        return sum(r["count"] * r[key] for r in main)

    ops_share = sum(r["count"] * r["bound_ms"] for r in main
                    if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2_err": max(r["rel_l2_err"] for r in rows),
        "tolerance": {"rel_l2": REL_L2_TOL, "max_of_max_ref": MAX_TOL},
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if ops_share >= total("bound_ms") / 2
                     else "bytes"),
        "library_ms": total("library_ms"),
        "launches_per_768x768_decode": sum(r["count"] for r in main),
        "per_launch": rows,
    }


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def check_batch(rt, written, singles, counts):
    """decode_batch of all streams against the single decodes; then, per
    768x768 stream, a batch of that stream twice: its row must equal the
    row the stream got beside the other stream, bit for bit."""
    def launched(fn):
        before = (counts[0].launches, counts[1].launches)
        out = fn()
        torch.cuda.synchronize()
        return out, (counts[0].launches - before[0],
                     counts[1].launches - before[1])

    streams = [s for s, _, _ in written]
    batch, got = launched(lambda: rt.decode_batch(streams))
    want = (K1_PER_CALL["768x768"] + K1_PER_CALL["512x768"],
            K2_PER_CALL["768x768"] + K2_PER_CALL["512x768"])
    if got != want:
        raise AssertionError(f"decode_batch launched K1/K2 {got}, "
                             f"expected {want}")
    for i, (a, b) in enumerate(zip(batch, singles)):
        if a.shape != b.shape:
            raise AssertionError(f"decode_batch[{i}] shape {tuple(a.shape)}")
        diff = (a - b).abs()
        rel_l2 = (diff.norm() / b.norm()).item()
        rel_max = (diff.max() / b.abs().max()).item()
        print(f"decode_batch[{i}] vs decode: relative L2 {rel_l2:.3e} (tol "
              f"{BATCH_REL_L2_TOL}), max diff {rel_max:.3e} of max |image| "
              f"(tol {BATCH_MAX_TOL})", flush=True)
        if not (rel_l2 <= BATCH_REL_L2_TOL and rel_max <= BATCH_MAX_TOL):
            raise AssertionError(f"decode_batch[{i}] differs from decode")
    # the 512x768 stream is a bucket of its own: the same program as decode
    if not torch.equal(batch[2], singles[2]):
        raise AssertionError("a one-stream bucket differs from decode")
    for row in (0, 1):
        twice, got = launched(lambda: rt.decode_batch([streams[row]] * 2))
        if got != (K1_PER_CALL["768x768"], K2_PER_CALL["768x768"]):
            raise AssertionError(f"decode_batch launched K1/K2 {got}")
        if not torch.equal(twice[row], batch[row]):
            raise AssertionError(f"decode_batch row {row} depends on the "
                                 f"other stream of its bucket")
        same = torch.equal(twice[0], twice[1])
        print(f"stream {row} twice in one batch: row {row} equals its row "
              f"beside stream {1 - row}; the two rows bit-identical to each "
              f"other: {same}", flush=True)


def main_path(seed: int):
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.ops import conv3x3 as k2
    from onedc_tpu_torch.ops import flash_attention as k1

    with torch.device("cuda"):
        model = OneDC()
    init_random_weights(model, seed)
    rt = OneDCRuntime(model, dtype=torch.bfloat16)

    sizes = [(768, 768), (768, 768), (512, 768)]
    written = [write_synthetic_stream(rt, h, w, seed + i)
               for i, (h, w) in enumerate(sizes)]
    for (h, w), (s, _, _) in zip(sizes, written):
        print(f"stream {h}x{w}: {len(s)} bytes, "
              f"{len(s) * 8 / (h * w):.4f} bpp", flush=True)

    k1.launches = 0
    k2.launches = 0
    singles = []
    for (h, w), (stream, y_hat_w, steps_w) in zip(sizes, written):
        bucket = f"{h}x{w}"
        before = (k1.launches, k2.launches)
        trace = {}
        img = rt.decode(stream, trace)
        torch.cuda.synchronize()
        got = (k1.launches - before[0], k2.launches - before[1])
        want = (K1_PER_CALL[bucket], K2_PER_CALL[bucket])
        if got != want:
            raise AssertionError(f"{bucket} decode launched K1/K2 {got}, "
                                 f"expected {want}")
        for i, ((iw, sw), (ir, sr)) in enumerate(zip(steps_w,
                                                     trace["steps"])):
            if not (np.array_equal(iw, ir) and np.array_equal(sw, sr)):
                raise AssertionError(f"{bucket}: step {i} indexes/symbols "
                                     f"differ from the writer's")
        if not torch.equal(trace["y_hat"], y_hat_w):
            raise AssertionError(f"{bucket}: y_hat differs from the writer's")
        if img.shape != (1, h, w, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"{bucket}: bad image {tuple(img.shape)}")
        singles.append(img)
        print(f"decode {bucket}: symbols and y_hat equal the writer's; "
              f"K1/K2 launches {got}; image range "
              f"[{img.min().item():.3f}, {img.max().item():.3f}]",
              flush=True)

    check_batch(rt, written, singles, (k1, k2))
    launches = {"K1": k1.launches, "K2": k2.launches}

    # timing, after the counted run; a traced decode waits for the device
    # at each stage's end and records each stage's host ms
    wall = {}
    for bucket, i in (("768x768", 0), ("512x768", 2)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            rt.decode(written[i][0])
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        wall[bucket] = ts
    stages = {}
    for _ in range(3):
        trace = {}
        rt.decode(written[0][0], trace)
        for stage, ms in trace["stage_ms"].items():
            stages.setdefault(stage, []).append(ms)
    t0 = time.perf_counter()
    rt.decode_batch([s for s, _, _ in written[:2]])
    torch.cuda.synchronize()
    batch2_ms = (time.perf_counter() - t0) * 1e3
    print("decode wall ms " + json.dumps(wall), flush=True)
    print("traced stage ms (768x768, 3 decodes) " + json.dumps(stages),
          flush=True)
    print(f"decode_batch of two 768x768 streams: {batch2_ms:.1f} ms",
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from onedc_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"built kernels and rANS coder in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in build.CUDA_SOURCES:
        print(f"ptxas {name}:\n{build.ptxas_report(name)}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    k1_rows = check_k1(gen)
    k2_rows = check_k2(gen)
    torch.cuda.empty_cache()

    launches = main_path(args.seed)

    kernels = [
        summarize("flash_attention_fwd",
                  "onedc_tpu_torch/csrc/flash_attention.cu",
                  "onedc_tpu/nn/attention.py:43", k1_rows, launches["K1"]),
        summarize("gn_silu_conv3x3",
                  "onedc_tpu_torch/csrc/gn_silu_conv3x3.cu",
                  "onedc_tpu/ops/pallas_conv.py:292", k2_rows,
                  launches["K2"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
