"""The numerics the port's results depend on, pinned in one place.

The CDF index of a latent is a bucketed prior scale, so a writer and a
reader must compute the prior nets with the same arithmetic: one ulp can
move an index and desync rANS for the rest of the stream. torch's defaults
let cuDNN run f32 convolutions in TF32 and pick algorithms by timing, so
two processes could disagree. The entry points (``OneDCRuntime.encode*``,
``decode*``, ``Trainer.train_one_step``) therefore run inside
``pinned_numerics``: cuDNN on, no benchmarking, deterministic algorithms,
TF32 off for cuDNN and for cuBLAS matmuls. The caller's settings are back
when the call returns.

The JAX package has no counterpart: XLA's programs fix their own
arithmetic.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PINNED = {"cudnn.enabled": True, "cudnn.benchmark": False,
          "cudnn.deterministic": True, "cudnn.allow_tf32": False,
          "cuda.matmul.allow_tf32": False}


def current() -> dict:
    """The flags that ``PINNED`` names, as they are now."""
    return {"cudnn.enabled": torch.backends.cudnn.enabled,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@contextlib.contextmanager
def pinned_numerics():
    """Run the body with ``PINNED``; restore the caller's flags after."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(
            enabled=PINNED["cudnn.enabled"],
            benchmark=PINNED["cudnn.benchmark"],
            deterministic=PINNED["cudnn.deterministic"],
            allow_tf32=PINNED["cudnn.allow_tf32"]):
        torch.backends.cuda.matmul.allow_tf32 = \
            PINNED["cuda.matmul.allow_tf32"]
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def pinned(fn):
    """Decorator: ``fn`` runs inside ``pinned_numerics``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with pinned_numerics():
            return fn(*args, **kwargs)
    return wrapper
