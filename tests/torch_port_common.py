"""Shared fixtures of the port's CPU tests (tests/test_torch_*.py).

One tiny OneDC (``__graft_entry__._tiny_cfg``) per test process: the JAX
parameter shapes are ``jax.eval_shape`` of the model's init, stored in
``torch_golden/tiny_shapes.json`` (a jitted init of the whole model
compiles the training forward and takes minutes on a CPU; tracing it for
the shapes took 10-20 s per process; ``test_torch_golden_shapes.py``
traces it again), the values from a seeded numpy generator. The same
arrays go to the JAX package and, through ``state_dict_from_jax``, to the
port.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from __graft_entry__ import _tiny_cfg  # noqa: E402
from onedc_tpu.models.onedc import OneDC as JaxOneDC  # noqa: E402

TINY = _tiny_cfg()
SEED = 0
# kernels at half the variance-preserving gain keep the random nets'
# activations O(1), so f32 differences between the frameworks stay at the
# noise floor instead of growing through the residual stacks
GAIN = 0.5


# decoded images against the JAX package's: the UNet's x0 recovery divides
# by sqrt(alpha_bar(999)) ~ 0.069, which amplifies the frameworks' f32
# differences before the VAE
IMAGE_TOL = 2e-3


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU work at the tiny sizes is small: with torch's default
    thread pool beside the suite's other workers it spends its time
    waiting on the pool (a port CLI run took 54 s instead of 4 under five
    busy processes, a two-step ``Trainer`` run 188 s instead of 5). A test
    module takes it with ``pytestmark = pytest.mark.usefixtures(...)``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_images():
    """The two test images, (1, H, W, 3) f32 in [-1, 1]: 64x64 and a ragged
    50x39 (both pad to 64x64)."""
    rng = np.random.default_rng(7)
    return [rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32),
            rng.uniform(-1, 1, (1, 50, 39, 3)).astype(np.float32)]


def fill_params(shapes, rng: np.random.Generator):
    """Seeded f32 leaves for a flax shape tree: kernels ~ GAIN * N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2)."""
    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (GAIN * rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


# the tiny model's Codeformer distillation (stage I): a 4-token window,
# which divides the 4x4 code grid of a 128x128 image, and a 32-wide VQGAN
CODEFORMER = dict(use_codeformer=True, codeformer_window=4, vqgan_hidden=32)


def tiny_jax_model(seed: int = SEED, codeformer: bool = False):
    """(flax OneDC, params as nested dicts of numpy arrays), built once per
    seed and process (``tiny_jax_model()`` and ``tiny_jax_model(SEED)`` are
    one entry: tracing the init takes 10-20 s on a CPU); ``codeformer``:
    with ``CODEFORMER``, traced at 128x128."""
    return _tiny_jax_model(seed, codeformer)


def stored_shapes(codeformer: bool = False):
    """The tiny model's parameter shapes from ``torch_golden/
    tiny_shapes.json``, as the nested dict of ``jax.ShapeDtypeStruct``
    that ``jax.eval_shape`` of its init gives."""
    from torch_golden import tiny_shapes

    tree: dict = {}
    for path, shape in tiny_shapes.load()[
            "codeformer" if codeformer else "plain"].items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _tiny_jax_model(seed: int, codeformer: bool):
    model = JaxOneDC(**TINY, **(CODEFORMER if codeformer else {}))
    return model, fill_params(stored_shapes(codeformer),
                              np.random.default_rng(seed))


def port_model(seed: int = SEED, codeformer: bool = False, **overrides):
    """A fresh port OneDC holding the same weights as ``tiny_jax_model``;
    ``overrides`` change keys of the tiny config that add no weights
    (``z_only``, ``force_zero_thres``)."""
    from onedc_tpu_torch.models.onedc import OneDC
    from onedc_tpu_torch.utils.convert import state_dict_from_jax

    model = OneDC(**{**TINY, **(CODEFORMER if codeformer else {}),
                     **overrides})
    model.load_state_dict(state_dict_from_jax(
        tiny_jax_model(seed, codeformer)[1]), strict=True)
    return model.eval().requires_grad_(False)


# the reference's module paths of the Codeformer and the VQGAN
# (``codec_module.py:472-511``, ``maskgit_vqgan.py``), from the port's: the
# inverse of the porters' rule tables (``utils/port_torch.py``)
_REFERENCE_NAMES = {
    "codeformer": [
        (r"^up_block0\.", "up_sample.0."), (r"^up_expand\.", "up_sample.1."),
        (r"^up_block1\.", "up_sample.3."), (r"^swin(\d)\.", r"blocks.\1."),
        (r"^head_0\.", "mlp_head.0."), (r"^head_norm0\.", "mlp_head.1."),
        (r"^head_3\.", "mlp_head.3."), (r"^head_norm1\.", "mlp_head.4."),
        (r"^head_out\.", "mlp_head.6."),
        (r"\.attn\.", ".attention_block."),
        (r"\.mlp_0\.", ".mlp_block.net.0."),
        (r"\.mlp_2\.", ".mlp_block.net.2."),
        (r"\.dc\.conv1_0\.", ".block.0.conv1.0."),
        (r"\.dc\.depth_conv\.", ".block.0.depth_conv."),
        (r"\.dc\.conv2\.", ".block.0.conv2."),
        (r"\.dc\.adaptor\.", ".block.0.adaptor."),
        (r"\.ffn\.conv\.", ".block.1.conv."),
        (r"\.ffn\.conv_out\.", ".block.1.conv_out.")],
    "vqgan": [
        (r"^encoder\.down_(\d)_block_(\d)\.", r"encoder.down.\1.block.\2."),
        (r"^(encoder|decoder)\.mid_(\d)\.", r"\1.mid.\2."),
        (r"^decoder\.up_(\d)_block_(\d)\.", r"decoder.up.\1.block.\2."),
        (r"^decoder\.up_(\d)_conv\.", r"decoder.up.\1.upsample_conv."),
        (r"^quantize\.embedding$", "quantize.embedding.weight")],
}


def reference_state(module, kind: str):
    """A port module's state dict (numpy f32) under the reference's names:
    ``kind`` "codeformer" or "vqgan"."""
    import re

    out = {}
    for key, value in module.state_dict().items():
        for pattern, repl in _REFERENCE_NAMES[kind]:
            key = re.sub(pattern, repl, key)
        out[key] = value.detach().float().numpy().copy()
    return out


def subtree(params, *path):
    for k in path:
        params = params[k]
    return params


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return to_np(t.permute(0, 2, 3, 1))


def seeded_state(module, seed: int):
    """Seeded f32 numpy values for every entry of a port module's state
    dict, drawn in sorted key order and in the torch layout, by
    ``fill_params``'s rules: weights of rank >= 2 ~ GAIN * N(0, 1/fan_in),
    1-d weights (norms) ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2). The
    module may live on the meta device (shapes only)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        noise = rng.standard_normal(shape)
        if key.endswith(".weight") and len(shape) >= 2:
            arr = GAIN * noise / np.sqrt(np.prod(shape[1:]))
        elif key.endswith(".weight"):
            arr = 1 + 0.1 * noise
        else:
            arr = 0.1 * noise
        out[key] = arr.astype(np.float32)
    return out


def load_seeded(module, seed: int):
    """``module`` with ``seeded_state(module, seed)`` loaded strictly (in
    place of meta tensors too); returns it."""
    state = {k: torch.from_numpy(v) for k, v in
             seeded_state(module, seed).items()}
    module.load_state_dict(state, strict=True, assign=True)
    return module
