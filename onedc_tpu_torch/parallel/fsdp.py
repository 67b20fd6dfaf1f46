"""FSDP: parameters, gradients and optimizer state sharded over the mesh's
``data`` axis.

JAX counterpart: ``onedc_tpu/parallel/fsdp.py``. JAX annotates every leaf
of the train state with ``_spec_for`` (:28-38: the largest dim that the
axis divides, or replication for a leaf under ``MIN_SHARD_SIZE`` elements
or with no such dim) and lets XLA insert the all-gathers and
reduce-scatters. The port applies FSDP2's ``fully_shard`` with the same
rule as its ``shard_placement_fn``: to each child of a trainable top-level
submodule, to that submodule, then to the root. Each unit all-gathers its
parameters for its forward (again for its backward, and again where remat
recomputes it) and reduce-scatters its gradients into the shards.

Documented differences:
- FSDP2 cannot leave one parameter of a sharded unit replicated, so a
  parameter that ``spec_for`` replicates (small, or no divisible dim) is
  put in ``ignored_params``: it stays a plain tensor on every rank, and the
  step all-reduces its gradient (the mean over the data ranks,
  ``all_reduce_mean_``), which is what XLA's replicated leaf gets.
- The frozen submodules (``vae``, ``vqgan``, ``real_unet``, ...) are
  ignored too, where JAX shards them as any leaf: they have no optimizer
  state to save, and the VAE's K2 convs read their weights in the HWIO
  layout that ``nn/vae.py:hwio_conv_weights`` gives them once. A frozen
  parameter that still gets a gradient (the VAE decoder's, which stage I's
  ``grad_norm`` counts) is all-reduced with the replicated ones.

FSDP2 shards contiguous parameters only: a sharded parameter is laid out
contiguous (NCHW) first, where the trainer keeps channels_last on the
card; the frozen, ignored ones keep their layout.

The optimizers (``train/step.py``) update each rank's shard in place
(``local``); their checkpoint state is the full tensors
(``train/step.py:AdamW.named_state``, ``utils/checkpoint.py``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from .mesh import DATA_AXIS

MIN_SHARD_SIZE = 2 ** 14  # below this, replication is cheaper


def spec_for(shape: Sequence[int], axis_size: int) -> Optional[int]:
    """The dim to shard over an axis of ``axis_size`` ranks (the largest
    that it divides, the first of equal ones), or None to replicate: a
    tensor under ``MIN_SHARD_SIZE`` elements or with no divisible dim
    (JAX ``_spec_for``, as a dim instead of a ``PartitionSpec``)."""
    if not shape or int(np.prod(shape)) < MIN_SHARD_SIZE:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0:
            return i
    return None


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view: writing it writes the
    DTensor), or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_info(t: torch.Tensor) -> Optional[Tuple[int, dist.ProcessGroup]]:
    """(sharded dim, its group) of a DTensor sharded over one mesh dim,
    else None."""
    if not isinstance(t, DTensor):
        return None
    (placement,) = t.placements
    if not isinstance(placement, Shard):
        return None
    return placement.dim, t.device_mesh.get_group()


def sharded_like(shard: torch.Tensor, param: torch.Tensor, dim: int,
                 shape: Sequence[int]) -> torch.Tensor:
    """``shard``, this rank's part of a tensor of ``shape`` split along
    ``dim`` as ``param`` is split over its mesh, as a DTensor view (the
    checkpoint gathers it whole)."""
    shape = tuple(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(shard, param.device_mesh, [Shard(dim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def all_reduce_mean_(tensors: Iterable[torch.Tensor],
                     group: Optional[dist.ProcessGroup]) -> None:
    """Replace each tensor by its mean over ``group``'s ranks, in one
    flattened all-reduce per dtype."""
    tensors = [t for t in tensors if t is not None]
    if group is None or dist.get_world_size(group) == 1 or not tensors:
        return
    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_model(model: nn.Module, mesh, frozen: Sequence[str] = (),
                forward_methods: Sequence[str] = ()) -> List[nn.Parameter]:
    """FSDP2 over ``mesh``'s data axis, in place: ``fully_shard`` on each
    child (that holds a sharded parameter) of every top-level submodule
    not named in ``frozen``, on that submodule, then on ``model``; each
    parameter sharded on ``spec_for``'s dim. ``forward_methods``: methods
    of ``model`` that the trainer calls in place of ``forward``
    (``register_fsdp_forward_method``). Returns the parameters left
    replicated that take gradients: the step all-reduces those
    (``all_reduce_mean_``)."""
    from torch.distributed.fsdp import fully_shard, \
        register_fsdp_forward_method

    data = mesh[DATA_AXIS]
    n = data.size()
    held = {p for name, p in model.named_parameters()
            if name.split(".")[0] in frozen}
    ignored = held | {p for p in model.parameters()
                      if spec_for(tuple(p.shape), n) is None}

    def placement(p):
        return Shard(spec_for(tuple(p.shape), n))

    with torch.no_grad():
        for p in model.parameters():
            if p not in ignored and not p.is_contiguous():
                p.data = p.data.contiguous()

    def wrap(module):
        fully_shard(module, mesh=data, shard_placement_fn=placement,
                    ignored_params=ignored)

    for name, top in model.named_children():
        if name in frozen or all(p in ignored for p in top.parameters()):
            continue
        for child in top.children():
            if any(p not in ignored for p in child.parameters()):
                wrap(child)
        wrap(top)
    wrap(model)
    for method in forward_methods:
        register_fsdp_forward_method(model, method)
    return [p for p in model.parameters()
            if p in ignored and p.requires_grad]
