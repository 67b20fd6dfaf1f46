"""The stored JAX outputs of ``tests/test_torch_stage2.py`` are the JAX
package's: recomputed from JAX, they equal the file
(``tests/torch_golden/stage2_reference.py``; about a minute of JAX
compiles, so marked slow)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_golden import stage2_reference as ref  # noqa: E402


@pytest.mark.slow
def test_stored_stage2_outputs_are_jax_outputs():
    stored = ref.load()
    fresh = ref.compute()
    assert sorted(fresh) == sorted(stored)
    assert [k for k in stored if not np.array_equal(stored[k], fresh[k])] \
        == []
