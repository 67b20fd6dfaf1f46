"""The port pins its numerics: inside ``OneDCRuntime.encode*``, ``decode*``
and ``Trainer.train_one_step`` cuDNN is on, deterministic and not
benchmarking, and TF32 is off for cuDNN and cuBLAS, whatever the caller
set; after the call the caller's settings are back."""

import numpy as np
import pytest
import torch

from onedc_tpu_torch.utils import numerics
from torch_port_common import one_torch_thread, TINY, seeded_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the opposite of every pinned flag
CALLER = {"cudnn.enabled": False, "cudnn.benchmark": True,
          "cudnn.deterministic": False, "cudnn.allow_tf32": True,
          "cuda.matmul.allow_tf32": True}


def _set(flags):
    torch.backends.cudnn.enabled = flags["cudnn.enabled"]
    torch.backends.cudnn.benchmark = flags["cudnn.benchmark"]
    torch.backends.cudnn.deterministic = flags["cudnn.deterministic"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]


@pytest.fixture
def caller_flags():
    """The caller's flags set to CALLER for the test, the process's own
    restored after it."""
    before = numerics.current()
    _set(CALLER)
    yield
    _set(before)


def _recording(obj, name, seen):
    """Patch ``obj.name`` to record the flags it runs under."""
    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        seen.append(numerics.current())
        return inner(*args, **kwargs)
    setattr(obj, name, wrapper)


def test_pinned_flags_are_the_opposite_of_the_callers():
    assert set(CALLER) == set(numerics.PINNED)
    assert all(CALLER[k] != v for k, v in numerics.PINNED.items())


def test_runtime_entry_points_pin_numerics(caller_flags):
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime

    torch.manual_seed(0)
    rt = OneDCRuntime(OneDC(**TINY), device="cpu")
    seen = []
    _recording(rt.model, "encode_device", seen)
    _recording(rt.model, "decode_device_x0", seen)
    images = seeded_images()
    stream, _ = rt.encode(images[0])
    rt.encode_batch(images[0])
    rt.encode_many(images)
    rt.decode(stream)
    rt.decode_batch([stream])
    assert len(seen) == 6
    assert all(s == numerics.PINNED for s in seen)
    assert numerics.current() == CALLER


def test_trainer_step_pins_numerics(caller_flags, tmp_path):
    from onedc_tpu_torch.train.trainer import Trainer

    cfg = dict(allow_no_lpips=True, batch_size=1, resolutions=[64],
               model=dict(TINY), run_dir=str(tmp_path / "run"))
    images = np.zeros((1, 64, 64, 3), np.float32)
    tr = Trainer(cfg, device="cpu", batches=iter([{"image": images}]))
    seen = []
    tr.step_fn = lambda state, batch, generator: seen.append(
        numerics.current()) or {}
    tr.train_one_step(0)
    assert seen == [numerics.PINNED]
    assert numerics.current() == CALLER
