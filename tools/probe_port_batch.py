"""Which ops of the PyTorch port's batched decode are not batch-invariant,
on one card.

    python3 tools/probe_port_batch.py [--seed N]

Full-width OneDC on seeded bf16 weights and one 768x768 stream, written as
``chip_smoke.py`` writes them. Records every call of a leaf module (and of
each attention module, so K1 and the plain attention count as one op) in
the codec finish, the UNet and the VAE decoder; then calls each op again
on its recorded batch-1 inputs and on the same inputs stacked twice, and
lists the ops whose two rows differ from each other ("rows differ") or
whose row 0 differs from the batch-1 result ("batch 2 != batch 1"). Last,
how much the random-weight VAE amplifies 0.2 % of noise on x0.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def twice(a):
    if not (isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == 1):
        return a
    r = torch.cat([a, a])
    if a.dim() == 4 and not a.is_contiguous() and a.is_contiguous(
            memory_format=torch.channels_last):
        r = r.contiguous(memory_format=torch.channels_last)
    return r


def first(o):
    return o[0] if isinstance(o, tuple) else o


@torch.no_grad()
def probe(label, root, run, atomic):
    calls, hooks = [], []
    for name, mod in root.named_modules():
        if isinstance(mod, atomic) or not any(mod.children()):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, kw, name=name: calls.append((name, m, a, kw)),
                with_kwargs=True))
    run()
    for h in hooks:
        h.remove()
    rows_differ, batch_differ = [], []
    for name, mod, args, kwargs in calls:
        one = first(mod(*args, **kwargs))
        two = first(mod(*map(twice, args),
                        **{k: twice(v) for k, v in kwargs.items()}))
        if two.shape[0] != 2:
            continue
        shape = tuple(args[0].shape) if args else ()
        if not torch.equal(two[0], two[1]):
            rows_differ.append(f"{name} {type(mod).__name__} {shape}")
        elif not torch.equal(two[:1], one):
            batch_differ.append(f"{name} {type(mod).__name__} {shape}")
    print(f"[{label}] {len(calls)} op calls; rows differ: "
          f"{len(rows_differ)}; batch 2 != batch 1 (rows equal): "
          f"{len(batch_differ)}", flush=True)
    for tag, names in (("rows differ", rows_differ),
                       ("batch 2 != batch 1", batch_differ)):
        for n in names:
            print(f"    {tag}: {n}", flush=True)


@torch.no_grad()
def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_port_batch: no CUDA device", file=sys.stderr)
        return 1
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.nn.unet_sd import CrossAttention
    from onedc_tpu_torch.nn.vae import VaeAttention
    from onedc_tpu_torch.ops import build

    print(chip_smoke.card_line(), flush=True)
    build.build_all()
    with torch.device("cuda"):
        model = OneDC()
    chip_smoke.init_random_weights(model, args.seed)
    rt = OneDCRuntime(model, dtype=torch.bfloat16)
    m = rt.model
    atomic = (CrossAttention, VaeAttention)

    stream, y_hat, _ = chip_smoke.write_synthetic_stream(rt, 768, 768,
                                                         args.seed)
    z = torch.from_numpy(rt.z_indices(rt.parse(stream))).to(rt.device)
    zs = m.codec.decompress_begin(z)["z_semantic"]
    probe("codec finish", m.codec,
          lambda: m.codec.decompress_finish(y_hat, zs), atomic)
    x_hat, y_sem = m.codec.decompress_finish(y_hat, zs)
    t = torch.full((1,), m.conditioning_timestep, dtype=torch.int32,
                   device=rt.device)
    probe("UNet", m.unet,
          lambda: m.unet(x_hat, t, y_sem.flatten(2).transpose(1, 2)), atomic)
    x0 = m.decode_device_x0(y_hat, zs)
    probe("VAE", m.vae, lambda: m.decode_device_vae(x0), atomic)

    img = m.decode_device_vae(x0).float()
    g = torch.Generator(device=rt.device).manual_seed(args.seed)
    noisy = x0.float() * (1 + 2 ** -9 * torch.randn(
        x0.shape, generator=g, device=rt.device))
    diff = m.decode_device_vae(noisy.to(x0.dtype)).float() - img
    print(f"VAE image with 0.2 % noise on x0: relative L2 "
          f"{(diff.norm() / img.norm()).item():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    from onedc_tpu_torch.utils.numerics import pinned_numerics

    with pinned_numerics():
        sys.exit(main())
