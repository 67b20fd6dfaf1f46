"""The device an entry point runs on: the card unless the caller names
another. The runtime, the trainer, the inference CLI and the
model-code-free serving bundles all resolve theirs here."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no GPU and no device
    named is an error, not a fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")
