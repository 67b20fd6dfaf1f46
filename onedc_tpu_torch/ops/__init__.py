"""See the package docstring of onedc_tpu_torch.

``torch._dynamo`` is imported here, with the operators' modules, and not
lazily by the first call of a ``torch.library`` operator: that lazy import
runs ``torch.fx``'s ``wrap``, whose frame sits in a reference cycle that
reaches up the caller's frames, so the first operator call of a process
would hold its caller (a runtime or a trainer, and their weights) until
the collector runs."""

import torch._dynamo  # noqa: F401
