"""A w8a8 serving bundle (``utils/aot.py`` on a ``quant="w8a8"`` runtime)
served by ``ServingDecoder`` with no model code, on the CPU at the tiny
geometry: the mirror of ``tests/test_quant.py::
test_w8a8_aot_export_carries_quant``. Its own file, beside
``test_torch_w8a8.py``, so that ``--dist loadfile`` runs the export (a
minute of tracing) on another worker than that file's JAX compiles.

Limits: the bundle's images against the w8a8 runtime's pipelined decode at
the bundle's chunking, 1e-4 (the batch-row tolerance of
``test_torch_serving.py``; the same programs on the same shapes: four
streams, two full chunks, since a ragged chunk that the bundle pads to its
batch is another batch, which moves a w8a8 image as far as the
quantization itself: ``test_torch_w8a8.py``); against the exact runtime's,
more than 1e-3 apart (the quantization rode the export).
"""

import json

import numpy as np
import pytest

from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.serving.decoder import ServingDecoder
from onedc_tpu_torch.utils import aot
from torch_port_common import (  # noqa: F401  (a fixture)
    one_torch_thread,
    port_model,
    seeded_images,
)

BATCH = 2
BATCH_TOL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A 64x64 x 2 bundle of a w8a8 runtime (gate 0: the tiny widths sit
    below 512), its ``ServingDecoder`` decode of four streams, the w8a8
    runtime's and the exact runtime's pipelined decodes of them."""
    out = tmp_path_factory.mktemp("w8a8_bundle")
    model = port_model()
    exact = OneDCRuntime(model, device="cpu")
    rt = OneDCRuntime(model, device="cpu", quant="w8a8")
    ims = seeded_images()
    ims += [np.ascontiguousarray(im[:, ::-1]) for im in ims]
    streams = [exact.encode(im)[0] for im in ims]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ONEDC_Q8_MIN_CH", "0")
        mp.setenv("ONEDC_PIPELINE_CHUNK", str(BATCH))
        mp.setenv("ONEDC_VAE_CHUNK", str(BATCH))
        aot.save_bundle(aot.export_serving_bundle(rt, 64, 64, batch=BATCH),
                        out)
        aot.save_weights(rt, out / "weights.safetensors")
        want = rt.decode_batch(streams)
        want_exact = exact.decode_batch(streams)
    dec = ServingDecoder(out, out / "weights.safetensors", device="cpu")
    return out, dec, dec.decode_batch(streams), want, want_exact


def test_w8a8_bundle_serves_the_w8a8_runtimes_images(served):
    """``meta["quant"]`` is the runtime's; ``ServingDecoder``'s images
    equal the w8a8 runtime's pipelined ones within BATCH_TOL and differ
    from the exact runtime's; the x0 and VAE programs call the w8a8
    operators and the encode program none."""
    out, dec, got, want, want_exact = served
    meta = json.loads((out / "meta.json").read_text())
    assert meta["quant"] == "w8a8" and meta["vae"] == "large"
    for g, w, e in zip(got, want, want_exact):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=BATCH_TOL)
        assert float((g - e).abs().max()) > 1e-3

    def targets(name):
        dec.bundle.program(name)
        return {str(n.target) for n in dec.bundle.modules[name].graph.nodes
                if n.op == "call_function"}
    for name, ops in (("x0", {"onedc.w8a8_conv.default",
                              "onedc.w8a8_dense.default",
                              "onedc.w8a8_upsample.default"}),
                      ("vae", {"onedc.w8a8_conv.default",
                               "onedc.w8a8_dense.default",
                               "onedc.w8a8_upsample.default",
                               "onedc.affine_silu_conv3x3.default"})):
        assert ops <= targets(name), name
    assert not any("w8a8" in t for t in targets("encode"))


def test_prior_programs_are_the_same_in_every_quant_mode(served):
    """``export_serving_bundle(programs=)`` exports the named programs
    alone and refuses a name it does not know; an exact runtime's prior
    programs equal the w8a8 bundle's byte for byte (they are traced
    outside the quant mode), so one bundle's serve the other's."""
    out = served[0]
    exact = OneDCRuntime(port_model(), device="cpu")
    names = ("begin", "update0_i8")
    arts = aot.export_serving_bundle(exact, 64, 64, batch=BATCH,
                                     programs=names)
    assert sorted(arts) == sorted(names + ("meta",))
    for name in names:
        assert arts[name] == (out / f"{name}.pt2").read_bytes(), name
    with pytest.raises(ValueError, match="no bundle program"):
        aot.export_serving_bundle(exact, 64, 64, batch=BATCH,
                                  programs=("fused",))
