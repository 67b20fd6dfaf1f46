"""The port's worker loader (``loader: grain``, ``data/datasets.py:
make_grain_loader`` on ``torch.utils.data.DataLoader`` workers) and the
trainer's loader state (``train/trainer.py:_save_loader_state`` and the
restore in ``resume``, as JAX ``trainer.py:356-384``).

Its order is its own, not grain's, so it is held to what JAX's
``tests/test_resume_determinism.py`` holds grain's to: each epoch a
permutation, disjoint equal shares per rank, the same batches for the same
seed, and a stream resumed from a saved state equal to the uninterrupted
one."""

import multiprocessing

import numpy as np
import pytest

import torch_dist
from onedc_tpu_torch.data import datasets as pdata
from onedc_tpu_torch.data.images import save_image
from onedc_tpu_torch.train import trainer as ptrainer
from torch_port_common import TINY, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 23
BATCH = 4


class _Toy:
    """Items whose image holds their index."""

    def __len__(self):
        return N

    def __getitem__(self, i):
        return {"image": np.full((2, 2, 3), float(i), np.float32),
                "caption": f"c{i}", "name": str(i)}


def _ids(batch):
    assert batch["image"].shape == (len(batch["name"]), 2, 2, 3)
    ids = [int(n) for n in batch["name"]]
    assert batch["image"][:, 0, 0, 0].tolist() == ids
    assert batch["caption"] == [f"c{i}" for i in ids]
    return ids


def _take(it, n):
    return [_ids(next(it)) for _ in range(n)]


def test_each_epoch_is_a_permutation():
    ld = pdata.make_grain_loader(_Toy(), BATCH, seed=3, num_workers=0)
    per = N // BATCH
    assert (ld.rank, ld.world, ld.batches_per_epoch) == (0, 1, per)
    epochs = [sum(_take(ld, per), []) for _ in range(3)]
    for e, ids in enumerate(epochs):
        assert len(set(ids)) == len(ids) == per * BATCH
        assert ids == ld.epoch_order(e)[:per * BATCH].tolist()
        assert sorted(ld.epoch_order(e).tolist()) == list(range(N))
    assert epochs[0] != epochs[1] != epochs[2]
    plain = pdata.WorkerLoader(_Toy(), BATCH, shuffle=False, num_workers=0)
    assert _take(plain, 2) == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_take_disjoint_equal_shares(world):
    loaders = [pdata.WorkerLoader(_Toy(), BATCH, seed=5, num_workers=0,
                                  rank=r, world=world) for r in range(world)]
    for epoch in range(2):
        shares = [set(ld.epoch_order(epoch).tolist()) for ld in loaders]
        assert all(len(s) == N // world for s in shares)
        assert len(set().union(*shares)) == (N // world) * world
    per = loaders[0].batches_per_epoch
    seen = [sum(_take(ld, per), []) for ld in loaders]
    assert all(len(s) == per * BATCH for s in seen)
    assert len(set().union(*map(set, seen))) == world * per * BATCH


def test_a_rank_resumes_from_another_ranks_state():
    """The trainer saves the loader state on process 0 alone: rank 1 of 2,
    restored from rank 0's state, goes on with its own uninterrupted
    stream."""
    ranks = [pdata.WorkerLoader(_Toy(), BATCH, seed=5, num_workers=0,
                                rank=r, world=2) for r in range(2)]
    for ld in ranks:
        _take(ld, 3)
    state = ranks[0].get_state()
    want = _take(ranks[1], 4)
    fresh = pdata.WorkerLoader(_Toy(), BATCH, seed=5, num_workers=0,
                               rank=1, world=2)
    fresh.set_state(state)
    assert _take(fresh, 4) == want


def test_same_seed_same_batches():
    a = pdata.WorkerLoader(_Toy(), BATCH, seed=7, num_workers=0)
    b = pdata.WorkerLoader(_Toy(), BATCH, seed=7, num_workers=0)
    c = pdata.WorkerLoader(_Toy(), BATCH, seed=8, num_workers=0)
    want = _take(a, 12)
    assert _take(b, 12) == want
    assert _take(c, 12) != want


@pytest.mark.parametrize("consumed", [0, 3, 5, 7, 11])
def test_resume_from_saved_state_equals_uninterrupted(consumed):
    """Within, at and across epoch edges (5 batches an epoch)."""
    whole = pdata.make_grain_loader(_Toy(), BATCH, seed=9, num_workers=0)
    _take(whole, consumed)
    state = whole.get_state()
    want = _take(whole, 8)
    resumed = pdata.make_grain_loader(_Toy(), BATCH, seed=9, num_workers=0)
    resumed.set_state(state)
    assert _take(resumed, 8) == want


def test_two_workers_give_the_same_stream_and_close(monkeypatch):
    """Two worker processes prefetch ahead: the stream and its saved state
    are those of the in-process loader; ``close`` stops the workers, and a
    restored state starts new ones. A worker that hangs fails the test
    after a minute instead of holding it."""
    monkeypatch.setattr(pdata, "WORKER_TIMEOUT_S", 60)
    ref = pdata.WorkerLoader(_Toy(), BATCH, seed=11, num_workers=0)
    want = _take(ref, 9)
    before = set(multiprocessing.active_children())
    ld = pdata.WorkerLoader(_Toy(), BATCH, seed=11, num_workers=2)
    try:
        assert _take(ld, 4) == want[:4]
        assert len(set(multiprocessing.active_children()) - before) == 2
        state = ld.get_state()
        assert _take(ld, 2) == want[4:6]
        ld.set_state(state)  # back to batch 4, new workers
        assert _take(ld, 5) == want[4:9]
    finally:
        ld.close()
    assert set(multiprocessing.active_children()) == before


def test_state_of_another_stream_and_the_end_of_the_epochs():
    a = pdata.WorkerLoader(_Toy(), BATCH, seed=1, num_workers=0)
    for other in (pdata.WorkerLoader(_Toy(), BATCH, seed=2, num_workers=0),
                  pdata.WorkerLoader(_Toy(), 2, seed=1, num_workers=0),
                  pdata.WorkerLoader(_Toy(), BATCH, seed=1, num_workers=0,
                                     rank=1, world=2)):
        with pytest.raises(ValueError, match="another stream"):
            other.set_state(a.get_state())
    once = pdata.WorkerLoader(_Toy(), BATCH, seed=1, num_workers=0,
                              num_epochs=1)
    assert len(list(once)) == N // BATCH
    with pytest.raises(ValueError, match="no batch"):
        pdata.WorkerLoader(_Toy(), 12, num_workers=0, world=2)


# -- the trainer's loader state -----------------------------------------------

@pytest.fixture(scope="module")
def train_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    for i in range(5):
        save_image(rng.uniform(-1, 1, (72, 72, 3)).astype(np.float32),
                   root / f"im{i:02d}.png")
    return root


def _cfg(run_dir, data):
    return {"model": dict(TINY), "allow_no_lpips": True, "loader": "grain",
            "loader_workers": 0, "train_data": str(data), "batch_size": 2,
            "run_dir": str(run_dir), "max_checkpoint": 1, "seed": 4}


def test_trainer_saves_and_restores_the_loader_position(tmp_path,
                                                        train_folder):
    """``loader: grain`` no longer raises: the trainer reads batches from a
    ``WorkerLoader``; each checkpoint writes ``loader_state_<step>.bin``
    beside it (the oldest beyond ``max_checkpoint`` removed), and
    ``resume`` moves a fresh trainer's stream to the saved position: its
    next batch is the uninterrupted run's."""
    tr = ptrainer.Trainer(_cfg(tmp_path / "run", train_folder),
                          device="cpu")
    assert isinstance(tr.train_iter, pdata.WorkerLoader)
    assert tr.train_loader is None
    for step in (1, 2):
        next(tr.train_iter)
        tr.save_checkpoint(step)
    assert sorted(p.name for p in (tmp_path / "run").glob(
        "loader_state_*.bin")) == ["loader_state_000002.bin"]
    want = [next(tr.train_iter)["name"] for _ in range(3)]
    fresh = ptrainer.Trainer(_cfg(tmp_path / "run", train_folder),
                             device="cpu")
    assert fresh.resume() == 2
    assert [next(fresh.train_iter)["name"] for _ in range(3)] == want


def test_two_ranks_train_each_record_of_an_epoch_once(tmp_path):
    """``loader: grain`` over two gloo ranks: each rank reads its own share
    in batches of ``batch_size`` / 2 and trains them as its rows, with its
    rows of the global batch's noise, so one epoch trains every record
    once over both ranks."""
    data = tmp_path / "data"
    data.mkdir()
    n, res = 8, 64
    for i in range(n):  # record i: every pixel at level 20 * i
        save_image(np.full((res, res, 3), 20 * i / 127.5 - 1, np.float32),
                   data / f"im{i}.png")
    cfg = dict(_cfg(tmp_path / "run", data), batch_size=4,
               resolutions=[res])
    ranks = torch_dist.spawn(torch_dist.grain_epoch, 2, tmp_path / "spawn",
                             cfg)
    trained = []
    for steps in ranks:
        assert len(steps) == n // 4
        for image, noise in steps:
            assert image.shape == (2, res, res, 3)
            assert noise.shape[0] == 2
            trained += np.rint((image[:, 0, 0, 0] + 1) * 127.5 / 20
                               ).astype(int).tolist()
    assert sorted(trained) == list(range(n))
    # the ranks' rows of one global draw, not one draw each
    assert not np.array_equal(ranks[0][0][1], ranks[1][0][1])
