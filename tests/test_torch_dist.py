"""The port's process group, mesh and FSDP rule on the CPU
(``onedc_tpu_torch/parallel/{distributed,mesh,fsdp}.py``): ``spec_for``
against the JAX package's ``_spec_for``, the distributed utilities on two
gloo processes and in one, and the data axis's share of a batch."""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist
from onedc_tpu.parallel.fsdp import MIN_SHARD_SIZE as JAX_MIN_SHARD_SIZE
from onedc_tpu.parallel.fsdp import _spec_for
from onedc_tpu_torch.parallel import distributed, fsdp, mesh
from torch_golden import tiny_shapes

# tests/test_fsdp.py's shapes (:19-41), each at its axis size of 8
FSDP_TEST_SHAPES = [(128, 256), (256, 128), (129, 256), (129, 131, 3), (8,),
                    (), (3, 3, 256, 512), (JAX_MIN_SHARD_SIZE * 8,), (77,),
                    (320 * 4 * 9,), (JAX_MIN_SHARD_SIZE * 3 + 1,)]


def _jax_dim(spec: P):
    """A JAX PartitionSpec of the data axis as a dim, or None."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("shapes", ["test_fsdp", "tiny_model"])
def test_spec_for_is_the_jax_rule(shapes):
    """The same dim (or replication) as JAX's ``_spec_for`` for every shape
    of ``tests/test_fsdp.py`` at 8 ranks, and for every parameter shape of
    the tiny model (with and without the Codeformer) at 1, 2, 4 and 8."""
    assert fsdp.MIN_SHARD_SIZE == JAX_MIN_SHARD_SIZE
    if shapes == "test_fsdp":
        cases = [(s, 8) for s in FSDP_TEST_SHAPES]
    else:
        stored = tiny_shapes.load()
        cases = [(tuple(s), n) for tree in stored.values()
                 for s in tree.values() for n in (1, 2, 4, 8)]
    assert len(cases) > 10
    for shape, n in cases:
        assert fsdp.spec_for(shape, n) == _jax_dim(_spec_for(shape, n)), \
            (shape, n)
    if shapes == "test_fsdp":
        assert [fsdp.spec_for(s, 8) for s in FSDP_TEST_SHAPES] == [
            1, 0, 1, None, None, None, 3, 0, None, None, None]


class _Mesh:
    """A stand-in for a (data, tensor) DeviceMesh seen from one rank."""

    def __init__(self, data: int, rank: int):
        self.data, self.rank = data, rank

    def __getitem__(self, axis):
        return type("Axis", (), {"size": lambda _: self.data})()

    def get_local_rank(self, axis):
        return self.rank


def test_rank_rows_pad_and_split_as_jax():
    """A batch of n split over D ranks: padded to a multiple of D by
    repeating the last row (JAX ``_pad_batch``), rank r takes the r-th run;
    the real rows come first; with micro-batches each rank takes its part
    of each micro-batch, in order; one process takes every row."""
    assert mesh.rank_rows(5, None) == [0, 1, 2, 3, 4]
    assert mesh.rank_rows(4, None, micro=2) == [0, 1, 2, 3]
    shares = [mesh.rank_rows(5, _Mesh(2, r)) for r in (0, 1)]
    assert shares == [[0, 1, 2], [3, 4, 4]]
    assert [mesh.real_rows(5, _Mesh(2, r)) for r in (0, 1)] == [3, 2]
    assert [mesh.rank_rows(1, _Mesh(2, r)) for r in (0, 1)] == [[0], [0]]
    assert [mesh.real_rows(1, _Mesh(2, r)) for r in (0, 1)] == [1, 0]
    assert [mesh.rank_rows(8, _Mesh(2, r), micro=2) for r in (0, 1)] == [
        [0, 1, 4, 5], [2, 3, 6, 7]]
    with pytest.raises(ValueError, match="micro-batches"):
        mesh.rank_rows(6, _Mesh(2, 0), micro=2)


def test_distributed_utilities_on_two_ranks(tmp_path):
    """On two gloo processes: a second ``initialize`` is a no-op, the
    barrier returns, ``process_allgather`` stacks the ranks' values in rank
    order on each, ``reduce_mean_across_hosts`` gives both the mean."""
    results = torch_dist.spawn(torch_dist.utilities, 2, tmp_path)
    for rank, r in enumerate(results):
        assert (r["world"], r["rank"], r["main"]) == (2, rank, rank == 0)
        np.testing.assert_array_equal(r["gathered"], [[0, 10], [1, 11]])
        assert r["mean"] == {"a": 0.5, "b": 2.0}


def test_one_process_is_the_identity(monkeypatch):
    """Without torchrun's environment ``initialize`` joins no group, and
    the utilities issue no collective: the metrics dict itself comes back,
    ``process_allgather`` adds the process axis; explicit arguments must
    come together."""
    import torch.distributed as dist

    for key in distributed.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    metrics = {"a": 1.0}
    assert distributed.reduce_mean_across_hosts(metrics) is metrics
    assert distributed.process_allgather(np.array([3, 4])).tolist() == [
        [3, 4]]
    assert distributed.world_size() == 1 and distributed.is_main_process()
    distributed.sync_global_devices()
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("localhost:1", num_processes=2)
