"""The parameter shapes of the port tests' tiny JAX OneDC, stored.

``tests/torch_port_common.py:tiny_jax_model`` fills these shapes from a
seeded numpy generator; tracing the model's init (``jax.eval_shape``)
for them took 10-20 s in every test process. ``tiny_shapes.json`` holds
the flattened tree, "/"-joined paths to shapes, per variant (``plain``:
``TINY`` at 64x64; ``codeformer``: with ``CODEFORMER`` at 128x128);
``tests/test_torch_golden_shapes.py`` (marked slow) traces the init again
and asserts the file equals it.

Write the file:
  JAX_PLATFORMS=cpu python tests/torch_golden/tiny_shapes.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
FILE = HERE / "tiny_shapes.json"


def traced() -> dict:
    """{variant: {path: shape}} from ``jax.eval_shape`` of the init."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(HERE.parent.parent))
    from __graft_entry__ import _tiny_cfg
    from onedc_tpu.models.onedc import OneDC

    codeformer = dict(use_codeformer=True, codeformer_window=4,
                      vqgan_hidden=32)
    out = {}
    for name, extra, size in (("plain", {}, 64),
                              ("codeformer", codeformer, 128)):
        model = OneDC(**_tiny_cfg(), **extra)
        shapes = jax.eval_shape(
            lambda x: model.init({"params": jax.random.PRNGKey(0)}, x),
            jnp.zeros((1, size, size, 3), jnp.float32))
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            assert leaf.dtype == jnp.float32, path
            flat["/".join(p.key for p in path)] = list(leaf.shape)
        out[name] = flat
    return out


def load() -> dict:
    return json.loads(FILE.read_text())


if __name__ == "__main__":
    FILE.write_text(json.dumps(traced(), indent=0, sort_keys=True) + "\n")
    print(f"wrote {FILE}: {FILE.stat().st_size} bytes")
