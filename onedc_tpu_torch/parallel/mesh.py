"""The device mesh and the data axis's share of a batch.

JAX counterpart: ``onedc_tpu/parallel/mesh.py``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every process of the
group, with the JAX axis names:

- ``data``: the batch axis (data parallelism: DDP or FSDP in training, one
  share of a batch of images per rank in the batch codecs);
- ``tensor``: the rows of one image (``parallel/spatial.py``).

Where JAX places a global array sharded over ``data`` and reads it back
whole, the port hands each rank its rows (``rank_rows``) and all-gathers
the results (``gather_rows``, ``gather_objects``), so that every rank
returns the whole result, as a JAX global array reads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import init_single_process

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"


def make_mesh(device_type: Optional[str] = None, data: Optional[int] = None,
              tensor: int = 1) -> DeviceMesh:
    """A (data, tensor) mesh over every process of the group; without a
    group, one of a single process (the 1x1 mesh). ``device_type``: None
    takes "cuda" with a card, else "cpu"."""
    init_single_process()
    world = dist.get_world_size()
    if data is None:
        data = world // tensor
    if data * tensor != world:
        raise ValueError(f"a {data}x{tensor} mesh needs {data * tensor} "
                         f"processes, the group has {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, tensor),
                            mesh_dim_names=(DATA_AXIS, TENSOR_AXIS))


def axis_size(mesh: Optional[DeviceMesh], axis: str = DATA_AXIS) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh: Optional[DeviceMesh], axis: str = DATA_AXIS) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def padded_len(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def rank_rows(n: int, mesh: Optional[DeviceMesh], micro: int = 1
              ) -> List[int]:
    """This rank's rows of a batch of ``n``, padded to a multiple of the
    data axis by repeating the last row (JAX ``OneDCRuntime._pad_batch``,
    ``onedc_tpu/models/onedc.py:378-383``): rank r of D takes rows
    [r * k, (r + 1) * k), k = padded n / D. With ``micro`` > 1 (training's
    micro-batches; ``n`` a multiple of D * micro), the batch is ``micro``
    runs of consecutive rows and the rank takes its share of each, in
    order: its i-th local micro-batch is its part of the global i-th."""
    d, r = axis_size(mesh), axis_rank(mesh)
    if micro > 1:
        if n % (d * micro):
            raise ValueError(f"a batch of {n} does not split into {micro} "
                             f"micro-batches over {d} ranks")
        m, k = n // micro, n // micro // d
        return [i * m + r * k + j for i in range(micro) for j in range(k)]
    k = padded_len(n, d) // d
    return [min(i, n - 1) for i in range(r * k, (r + 1) * k)]


def real_rows(n: int, mesh: Optional[DeviceMesh]) -> int:
    """How many of this rank's ``rank_rows(n, mesh)`` are real (the
    padding rows come last)."""
    d, r = axis_size(mesh), axis_rank(mesh)
    k = padded_len(n, d) // d
    return max(0, min(n, (r + 1) * k) - r * k)


def gather_rows(local: torch.Tensor, mesh: Optional[DeviceMesh], n: int
                ) -> torch.Tensor:
    """Every data rank's ``rank_rows`` result, all-gathered along dim 0 in
    rank order and cut to the ``n`` real rows (the padding dropped)."""
    if axis_size(mesh) == 1:
        return local[:n]
    group = mesh[DATA_AXIS].get_group()
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)[:n]


def gather_objects(local: Sequence, mesh: Optional[DeviceMesh], n: int
                   ) -> list:
    """``gather_rows`` for lists of picklable results (containers), one
    list per rank of any length, concatenated in rank order."""
    if axis_size(mesh) == 1:
        return list(local)[:n]
    group = mesh[DATA_AXIS].get_group()
    parts: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, list(local), group=group)
    return [x for part in parts for x in part][:n]
