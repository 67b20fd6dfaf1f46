"""Process-group initialisation and cross-process utilities.

JAX counterpart: ``onedc_tpu/parallel/distributed.py``. The JAX package
runs one program per host and wires the hosts with
``jax.distributed.initialize``; the port runs one process per GPU, each
the same program (``torchrun --nproc-per-node N ...``), and wires them with
``torch.distributed``: NCCL on the card, gloo on the CPU. Beyond "only
process 0 writes logs and checkpoints" no code path depends on the rank.

A documented difference: where JAX logs a warning and carries on in one
process when an init found in the environment fails (``:49-55``), the port
raises. Carrying on would hide the other devices: a run on N GPUs would
train N copies of one process's model without a word.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables: any of them set means the process is one of a group
ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def default_backend() -> str:
    """NCCL where there is a card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group. With no argument, torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` (and ``LOCAL_RANK`` for the card);
    or all three arguments given (``coordinator_address`` a
    ``tcp://host:port`` or ``file://path`` rendezvous, or ``host:port``).
    A no-op in one process with no such environment, and when the group
    is already initialised. ``backend``: None takes NCCL on the card,
    gloo on the CPU. Any failure raises."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError("initialize: give coordinator_address, "
                             "num_processes and process_id together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    elif any(os.environ.get(k) for k in ENV_KEYS):
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return  # one process, nothing to wire
    init_group(backend or default_backend(), rank, world,
               init_method=init_method)


def init_group(backend: str, rank: int, world: int, *,
               init_method: Optional[str] = None, store=None) -> None:
    """``init_process_group`` with the card bound first under NCCL (the
    process's ``LOCAL_RANK``, else its rank modulo the cards)."""
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world, **kwargs)


def init_single_process(backend: Optional[str] = None) -> None:
    """A group of one process on an in-process store, where none exists:
    the degenerate 1x1 mesh that an FSDP run on one device needs."""
    if not dist.is_initialized():
        init_group(backend or default_backend(), 0, 1,
                   store=dist.HashStore())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def sync_global_devices(name: str = "barrier") -> None:  # noqa: ARG001
    """A barrier over every process (the reference's
    ``accelerator.wait_for_everyone``); nothing in one process."""
    if world_size() > 1:
        dist.barrier()


def process_allgather(x) -> np.ndarray:
    """Every process's value of ``x`` (an array or a scalar), stacked in
    rank order on every process: (n_processes, ...)."""
    x = np.asarray(x)
    if world_size() == 1:
        return x[None]
    out = [None] * world_size()
    dist.all_gather_object(out, x)
    return np.stack(out)


def reduce_mean_across_hosts(metrics: Dict[str, float]) -> Dict[str, float]:
    """The mean of a ``{name: scalar}`` dict over the processes (the
    reference's ``accelerator.reduce`` of the eval averages). In one
    process: the dict itself, no collective issued."""
    if world_size() == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = np.asarray([float(metrics[k]) for k in keys], np.float64)
    mean = process_allgather(vals).mean(axis=0)
    return {k: float(v) for k, v in zip(keys, mean)}
