"""Ahead-of-time export of the serving programs (``torch.export``).

JAX counterpart: ``onedc_tpu/utils/aot.py`` (``export_decode`` :56,
``export_encode`` :76, ``export_decode_z_only`` :96, ``load_exported``
:113, ``export_serving_bundle`` :123, ``save_bundle`` :196, ``main``
:212). A serving process wants the programs without the model stack: no
model classes, no tracing, just artifacts plus the weights. Each program
is a ``torch.export`` program of the runtime's own code, saved with
``torch.export.save``.

As in the JAX package the weights stay an argument of every program (the
first: a list of tensors, in the order of the bundle's ``meta.json``), so
an artifact holds no weight and one bundle serves every checkpoint of the
architecture; the weights travel as a flat safetensors file. A program is
traced on the runtime's device with its weights in the runtime's layout
(channels_last on the card, the VAE convs' HWIO), and the serving side
lays the weights out as ``meta.json`` records them: the prior programs
then run the same kernels on the same strides as the runtime, which
bit-exact CDF indexes need.

The kernels K1 and K2 are the custom operators ``onedc::flash_attention``
and ``onedc::affine_silu_conv3x3``, which pick their route when the
program runs: an artifact launches the kernels on the card and the plain
versions on the CPU.

Exported signatures (shapes fixed at export: one bundle per serving
bucket, e.g. 768x768 B=8; NHWC at the prior programs' boundary as in
``models/codec.py``, NCHW images):

- begin:    (w, z_indices[B,H/64,W/64] int32) -> {y_hat, means, common,
            z_semantic, indexes_r}
- update*:  (w, y_q_r int16 or int8, means, y_hat, common) ->
            {y_hat, means[, indexes_r]}
- x0:       (w, y_hat, z_semantic) -> x0[B,4,H/8,W/8]
- vae:      (w, x0) -> image[B,3,H,W]
- decode:   (w, y_hat, z_semantic) -> image (x0 and vae fused)
- encode:   (w, image[B,3,H,W] padded) -> the write plan
- z-only:   (w, z_indices) -> image
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..models.runtime import decode_begin, decode_update
from ..serving.bundle import load_exported  # noqa: F401  (the loader)

# the state dict prefixes each program reads
PROGRAM_PREFIXES = {
    "begin": ("codec.",), "update": ("codec.",), "x0": ("codec.", "unet."),
    "vae_large": ("vae.",), "vae_tiny": ("vae_tiny_dec.",),
    "encode": ("vae.", "codec."),
}


class _Call(torch.nn.Module):
    """``fn(model, *args)`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, model: torch.nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Program(torch.nn.Module):
    """forward(weights, *args): the model's ``fn(*args)`` computed with
    ``weights`` (tensors named by ``names``) in place of the model's own.
    The model is held outside the module's attributes, so no weight of it
    becomes a parameter or a constant of the exported program."""

    def __init__(self, model: torch.nn.Module, fn: Callable,
                 names: Sequence[str]):
        super().__init__()
        self._call = (_Call(model, fn),)
        self.names = list(names)

    def forward(self, weights: List[torch.Tensor], *args):
        call = self._call[0]
        return torch.func.functional_call(
            call, {f"model.{n}": w for n, w in zip(self.names, weights)},
            args, strict=False)


def weight_names(runtime, prefixes: Sequence[str]) -> List[str]:
    return [k for k in runtime.model.state_dict()
            if k.startswith(tuple(prefixes))]


def export_program(runtime, fn: Callable, prefixes: Sequence[str],
                   args: Tuple) -> torch.export.ExportedProgram:
    """``fn(model, *args)`` of the runtime's model as a program whose first
    argument is the list of the model's tensors under ``prefixes``."""
    names = weight_names(runtime, prefixes)
    state = runtime.model.state_dict()
    weights = [state[n] for n in names]
    # the nodes' source stack traces cost a quarter of the trace time and
    # half the artifact's bytes, and a serving process never reads them
    emit = getattr(torch.fx.config, "do_not_emit_stack_traces", False)
    torch.fx.config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            return torch.export.export(_Program(runtime.model, fn, names),
                                       (weights, *args), strict=False)
    finally:
        torch.fx.config.do_not_emit_stack_traces = emit


def _vae_prefixes(runtime) -> Tuple[str, ...]:
    return PROGRAM_PREFIXES["vae_large" if runtime.use_large_vae
                            else "vae_tiny"]


def _latent_shapes(runtime, height: int, width: int, batch: int):
    """Example (y_hat, z_semantic) of a padded size, NHWC, working dtype."""
    model = runtime.model
    c = model.codec.y_spatial_prior_reduction.out_channels
    sem = model.codec.hyper_dec.feat_in.out_channels
    kw = dict(dtype=runtime.dtype, device=runtime.device)
    return (torch.zeros((batch, height // 16, width // 16, c), **kw),
            torch.zeros((batch, height // 64, width // 64, sem), **kw))


def _check_padded(height: int, width: int) -> None:
    if height % 64 or width % 64:
        raise ValueError(f"export padded sizes (multiples of 64), got "
                         f"{height}x{width}")


def export_decode(runtime, height: int, width: int, batch: int = 1
                  ) -> torch.export.ExportedProgram:
    """The fused decode program (codec finish + UNet + VAE) of a padded
    size: (weights, y_hat, z_semantic) -> image NCHW."""
    _check_padded(height, width)
    large = runtime.use_large_vae
    return export_program(
        runtime, lambda m, yh, zs: m.decode_device_vae(
            m.decode_device_x0(yh, zs), large),
        PROGRAM_PREFIXES["x0"] + _vae_prefixes(runtime),
        _latent_shapes(runtime, height, width, batch))


def export_encode(runtime, height: int, width: int, batch: int = 1
                  ) -> torch.export.ExportedProgram:
    """The device half of encode (VAE posterior mean + codec compress ->
    the write plan, ``OneDC.encode_device``) of a padded size: (weights,
    image (B, 3, H, W) in the working dtype, padded) -> the plan."""
    _check_padded(height, width)
    image = torch.zeros((batch, height, width, 3), dtype=runtime.dtype,
                        device=runtime.device).permute(0, 3, 1, 2)
    return export_program(runtime, lambda m, x: m.encode_device(x),
                          PROGRAM_PREFIXES["encode"], (image,))


def export_decode_z_only(runtime, height: int, width: int, batch: int = 1
                         ) -> torch.export.ExportedProgram:
    """The z-only decode (z_indices -> image NCHW)."""
    if not runtime.z_only:
        raise ValueError("export_decode_z_only needs the z-only model")
    _check_padded(height, width)
    z = torch.zeros((batch, height // 64, width // 64), dtype=torch.int32,
                    device=runtime.device)
    large = runtime.use_large_vae
    return export_program(
        runtime, lambda m, zi: m.decode_device_z_only(zi, large),
        PROGRAM_PREFIXES["x0"] + _vae_prefixes(runtime), (z,))


def serialize(ep: torch.export.ExportedProgram) -> bytes:
    """The program's ``torch.export.save`` bytes, without its example
    inputs (they hold the weights)."""
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the staged serving bundle: the pipelined serving path as artifacts
# ---------------------------------------------------------------------------

def _layout(t: torch.Tensor) -> dict:
    """A tensor's dtype, shape and, where not contiguous, the order of its
    dims from the outermost in memory (``torch.empty_permuted``'s
    ``physical_layout``)."""
    out = {"dtype": str(t.dtype).removeprefix("torch."),
           "shape": list(t.shape)}
    if not t.is_contiguous():
        out["dim_order"] = sorted(range(t.dim()),
                                  key=lambda d: (-t.stride(d), d))
    return out


def export_serving_bundle(runtime, height: int, width: int, batch: int = 8
                          ) -> dict:
    """Export the staged programs that the pipelined schedule dispatches
    (``serving/pipeline.py``): begin, update0..3 (int16 and int8 symbol
    signatures: the schedule narrows the symbols of a chunk that fit),
    x0, vae, plus the fused decode and the encode device half. A serving
    process pairs them with the host rANS loop (``ServingDecoder``) and
    the host container writer (``ServingEncoder``). Returns {name: bytes}
    and "meta" (shapes, host-loop constants, the weights' layouts, export
    seconds per program)."""
    _check_padded(height, width)
    if runtime.z_only:
        raise ValueError("the serving bundle is the lambda model's; export "
                         "the z-only decode with export_decode_z_only")
    model = runtime.model
    zi = torch.zeros((batch, height // 64, width // 64), dtype=torch.int32,
                     device=runtime.device)
    with torch.no_grad():
        st = decode_begin(model.codec, zi)
    seconds: Dict[str, float] = {}
    arts: Dict[str, object] = {}

    def add(name, make):
        t0 = time.perf_counter()
        arts[name] = serialize(make())
        seconds[name] = time.perf_counter() - t0

    codec_only = PROGRAM_PREFIXES["begin"]
    add("begin", lambda: export_program(
        runtime, lambda m, z: decode_begin(m.codec, z), codec_only, (zi,)))
    for s in range(4):
        def step(m, yq, mu, yh, c, _s=s):
            return decode_update(m.codec, _s, yq, mu, yh, c)
        for suffix, dt in (("", torch.int16), ("_i8", torch.int8)):
            yq = torch.zeros(st["indexes_r"].shape, dtype=dt,
                             device=runtime.device)
            add(f"update{s}{suffix}", lambda: export_program(
                runtime, step, PROGRAM_PREFIXES["update"],
                (yq, st["means"], st["y_hat"], st["common"])))
    add("x0", lambda: export_program(
        runtime, lambda m, yh, zs: m.decode_device_x0(yh, zs),
        PROGRAM_PREFIXES["x0"], (st["y_hat"], st["z_semantic"])))
    with torch.no_grad():
        x0 = model.decode_device_x0(st["y_hat"], st["z_semantic"])
    large = runtime.use_large_vae
    add("vae", lambda: export_program(
        runtime, lambda m, x: m.decode_device_vae(x, large),
        _vae_prefixes(runtime), (x0,)))
    add("decode", lambda: export_decode(runtime, height, width, batch))
    add("encode", lambda: export_encode(runtime, height, width, batch))

    vae = _vae_prefixes(runtime)
    state = model.state_dict()
    arts["meta"] = {
        "height": height, "width": width, "batch": batch,
        "ds": runtime.ds,
        "z_fsq_levels": list(model.codec.z_vq.levels),
        "dtype": str(runtime.dtype).removeprefix("torch."),
        "indexes_dtype": str(st["indexes_r"].dtype).removeprefix("torch."),
        "symbol_dtypes": ["int16", "int8"],
        "quant": None,
        "vae": "large" if large else "tiny",
        "device": runtime.device.type,
        "torch": torch.__version__,
        "programs": {
            "begin": list(codec_only),
            **{f"update{s}{x}": list(PROGRAM_PREFIXES["update"])
               for s in range(4) for x in ("", "_i8")},
            "x0": list(PROGRAM_PREFIXES["x0"]), "vae": list(vae),
            "decode": list(PROGRAM_PREFIXES["x0"] + vae),
            "encode": list(PROGRAM_PREFIXES["encode"])},
        "weights": {k: _layout(state[k]) for k in
                    weight_names(runtime, PROGRAM_PREFIXES["x0"] + vae
                                 + PROGRAM_PREFIXES["encode"])},
        "export_seconds": seconds,
    }
    return arts


def save_bundle(arts: dict, out_dir) -> None:
    """Write a bundle dict to ``out_dir`` (``<name>.pt2`` + meta.json)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, data in arts.items():
        if name == "meta":
            with open(os.path.join(out_dir, "meta.json"), "w") as f:
                json.dump(data, f, indent=1)
        else:
            with open(os.path.join(out_dir, f"{name}.pt2"), "wb") as f:
                f.write(data)


def save_weights(runtime, path) -> None:
    """The runtime's weights as a flat safetensors file (the state dict's
    keys), in the runtime's dtype: the bundle decoder's and encoder's
    format."""
    from .safetensors import save_safetensors

    save_safetensors(runtime.model.state_dict(), path)


def main(argv=None):
    """CLI: export a serving bundle for a bucket.

    python -m onedc_tpu_torch.utils.aot --config cfg.yaml \\
        --bucket 768x768x8 --out bundles/768 [--save-weights] [key=value ...]
    """
    import argparse

    from ..config import load_config
    from ..eval.inference import build_runtime

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--config", default=None, help="model config yaml")
    p.add_argument("--bucket", required=True,
                   help="HxWxB serving bucket, e.g. 768x768x8")
    p.add_argument("--out", required=True, help="bundle output dir")
    p.add_argument("--save-weights", action="store_true",
                   help="also write weights.safetensors next to the bundle "
                        "(flat state dict keys, the ServingDecoder format)")
    args, overrides = p.parse_known_args(argv)

    cfg = load_config(args.config, overrides)
    if cfg.get("quant") is not None:
        raise NotImplementedError("quant bundles wait for the w8a8 serving "
                                  "mode (not ported)")
    h, w, b = (int(t) for t in args.bucket.split("x"))
    rt, _ = build_runtime(cfg)
    t0 = time.perf_counter()
    arts = export_serving_bundle(rt, h, w, batch=b)
    save_bundle(arts, args.out)
    if args.save_weights:
        save_weights(rt, os.path.join(args.out, "weights.safetensors"))
    names = ", ".join(sorted(k for k in arts if k != "meta"))
    print(f"bundle written to {args.out} in "
          f"{time.perf_counter() - t0:.1f} s: {names}")


if __name__ == "__main__":
    main()
