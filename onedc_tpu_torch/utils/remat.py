"""Rematerialisation of the stage-I forward (``gradient_checkpointing``).

JAX counterpart: ``onedc_tpu/train/step.py:_make_stage1_loss_fn`` (:204-238),
which wraps ``model.apply`` in ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``: the outputs of dot products with no
batch dimension are kept, everything else is recomputed in the backward
(convolutions, batched einsums and the Pallas kernels included).

Here the region runs under ``torch.utils.checkpoint`` (non-reentrant) with
a selective policy: the outputs of ``aten.mm`` / ``aten.addmm`` (dense
layers, the counterpart of JAX's unbatched dots) are saved, every other
op is recomputed, ``aten.convolution``, ``aten.bmm`` and the hand kernels
(K1 f32 and K2 f32 launch again in the backward) included.

Under FSDP (``parallel/fsdp.py``) the units inside the region gather
their parameters again in the recompute, and FSDP's hooks mark their work
with profiler annotations (``record_function``), of which the recompute
runs another number than the forward did. The selective checkpoint caches
ops by their count and would fail on them, so the annotation ops join
``SAC_IGNORED_OPS``, the ops it runs uncached (annotations compute
nothing).

Checkpointing restores the global RNG state only, never an explicit
``torch.Generator``: the codec's U(-0.5, 0.5) noise must be drawn before
the region and passed in, or the recompute draws other noise and the
gradients are wrong without a word (``OneDC.forward`` does so).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    SAC_IGNORED_OPS,
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default})
SAC_IGNORED_OPS.update({torch.ops.profiler._record_function_enter_new.default,
                        torch.ops.profiler._record_function_exit.default,
                        torch.ops.profiler._record_function_exit.
                        _RecordFunction})


def _policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialized(fn, *args):
    """``fn(*args)`` with its saved activations recomputed in the backward,
    but for the dense layers' products."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _policy))
