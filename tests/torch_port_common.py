"""Shared fixtures of the port's CPU tests (tests/test_torch_*.py).

One tiny OneDC (``__graft_entry__._tiny_cfg``) per test process: the JAX
parameter shapes come from ``jax.eval_shape`` of the model's init (a jitted
init of the whole model compiles the training forward and takes minutes
on a CPU), the values from a seeded numpy generator. The same arrays go to
the JAX package and, through ``state_dict_from_jax``, to the port.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
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


def tiny_jax_model(seed: int = SEED):
    """(flax OneDC, params as nested dicts of numpy arrays), built once per
    seed and process (``tiny_jax_model()`` and ``tiny_jax_model(SEED)`` are
    one entry: tracing the init takes 10-20 s on a CPU)."""
    return _tiny_jax_model(seed)


@functools.lru_cache(maxsize=None)
def _tiny_jax_model(seed: int):
    model = JaxOneDC(**TINY)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0)}, x),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    return model, fill_params(shapes, np.random.default_rng(seed))


def port_model(seed: int = SEED):
    """A fresh port OneDC holding the same weights as ``tiny_jax_model``."""
    from onedc_tpu_torch.models.onedc import OneDC
    from onedc_tpu_torch.utils.convert import state_dict_from_jax

    model = OneDC(**TINY)
    model.load_state_dict(state_dict_from_jax(tiny_jax_model(seed)[1]),
                          strict=True)
    return model.eval().requires_grad_(False)


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
