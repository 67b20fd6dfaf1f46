"""A dropped runtime, Evaluator or Trainer is freed when its last reference
goes, not when the collector next runs: none of them sits in a reference
cycle (a full-width model held until a collection costs its weights on
every later peak of the process). Each test runs its object's paths, drops
it with the collector off, and checks a weak reference to it."""

import gc
import weakref

import numpy as np
import pytest

from onedc_tpu_torch.data.images import save_image
from torch_port_common import (  # noqa: F401  (a fixture)
    TINY,
    one_torch_thread,
    port_model,
    seeded_images,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _freed(make, use):
    """``use(make())`` with the collector off, then True if dropping the
    object freed it and its model."""
    gc.collect()
    gc.disable()
    try:
        obj = make()
        use(obj)
        refs = [weakref.ref(obj), weakref.ref(obj.model)]
        del obj
        return [r() is None for r in refs]
    finally:
        gc.enable()


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_runtime_is_freed_without_the_collector(quant):
    """Encode, a single decode and a pipelined ``decode_batch`` (whose
    schedule once made a class per call, in a cycle that held the decode
    programs and through them the runtime)."""
    from onedc_tpu_torch.models.onedc import OneDCRuntime

    def use(rt):
        streams = [rt.encode(im)[0] for im in seeded_images()]
        rt.decode(streams[0])
        rt.decode_batch(streams)

    assert _freed(lambda: OneDCRuntime(port_model(), device="cpu",
                                       quant=quant), use) == [True, True]


def test_evaluator_is_freed_without_the_collector(tmp_path):
    from onedc_tpu_torch.eval.inference import Evaluator

    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    for i in range(2):
        save_image(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
                   tmp_path / "img" / f"{i}.png")
    cfg = dict(model=dict(TINY), device="cpu", use_bf16=False,
               dataset_path=str(tmp_path / "img"),
               output_path=str(tmp_path / "out"))

    def use(ev):
        ev.evaluate()
        ev.evaluate_batched()
        ev.decode_only(tmp_path / "out" / "bin")

    assert _freed(lambda: Evaluator(cfg), use) == [True, True]


def test_trainer_is_freed_without_the_collector(tmp_path):
    """A trainer after two steps, an eval epoch and a checkpoint."""
    from onedc_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    for sub, n in (("train", 2), ("eval", 1)):
        (tmp_path / sub).mkdir()
        for i in range(n):
            save_image(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
                       tmp_path / sub / f"{i}.png")
    cfg = dict(model=dict(TINY), allow_no_lpips=True, batch_size=1,
               resolutions=[64], total_steps=2, save_interval=2,
               log_interval=1, train_data=str(tmp_path / "train"),
               eval_data=str(tmp_path / "eval"),
               run_dir=str(tmp_path / "run"))
    assert _freed(lambda: Trainer(cfg, device="cpu"),
                  lambda tr: tr.train()) == [True, True]
