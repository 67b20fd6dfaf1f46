"""The tiny model's stored parameter shapes (``torch_golden/
tiny_shapes.json``, which ``torch_port_common.tiny_jax_model`` fills) are
the JAX package's: traced again, they equal the file (``jax.eval_shape``
of the init, 10-20 s a variant, so marked slow)."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_golden import tiny_shapes  # noqa: E402


@pytest.mark.slow
def test_stored_tiny_shapes_are_the_traced_init():
    assert tiny_shapes.traced() == tiny_shapes.load()
