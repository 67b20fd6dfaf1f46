"""The stored JAX runtime outputs (``tests/torch_golden/
runtime_reference.py``) are the JAX package's: computed again from JAX,
each file's arrays equal the stored ones (a minute or more of JAX work
each, so marked slow)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_golden import runtime_reference as ref  # noqa: E402


@pytest.mark.slow
@pytest.mark.parametrize("name", ref.NAMES)
def test_stored_runtime_outputs_are_jax_outputs(name):
    stored = ref.load(name)
    fresh = ref.compute(name)
    assert sorted(fresh) == sorted(stored)
    assert [k for k in stored if not np.array_equal(stored[k], fresh[k])] \
        == []
