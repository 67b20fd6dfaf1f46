"""Stage-I training step: optimizer, schedule, step function.

JAX counterpart: ``onedc_tpu/train/step.py`` (:29-94 ``make_optimizer``,
``make_frozen_labels``, ``make_masked_optimizer``, ``create_train_state``;
:148-238 ``make_train_step`` with ``grad_accum=1`` and the stage-I loss).
What it reproduces of optax, rule for rule:

- the learning rate: ``join_schedules([linear_schedule(0, lr, warmup),
  constant_schedule(lr)])`` read at the optimizer's count, so the first
  update (count 0) has lr 0 and moves no parameter, while the Adam moments
  still take the gradient in;
- ``clip_by_global_norm(grad_clip)``: the norm over the trainable
  gradients only (``multi_transform`` hands the inner chain only the
  "train" leaves), and the gradients scaled by ``max_norm / norm`` only
  when ``norm >= max_norm``, with no epsilon (not
  ``torch.nn.utils.clip_grad_norm_``);
- ``adamw(b1, b2, eps=1e-8, weight_decay)``: bias-corrected moments,
  ``m_hat / (sqrt(v_hat) + eps)``, plus ``weight_decay * p``, times -lr;
- the freeze (``multi_transform`` with ``set_to_zero``): parameters under a
  frozen top-level submodule stay out of the optimizer, and are left
  bit-identical. Their gradients are still computed where autograd reaches
  them, because the reported ``grad_norm`` is ``optax.global_norm`` over
  the whole gradient tree (``step.py:198``), the frozen VAE decoder's
  weight gradients included; the VAE encoder runs with no autograd record
  (its output is detached, ``stop_gradient`` in JAX), so its gradients are
  zero there and absent here.

The step updates the parameters in place (torch's way; the JAX state is
immutable). Gradients are cleared at the start of a step, not its end, so
the caller can read them after it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .losses import RDLoss


def warmup_constant_lr(count: int, lr: float, warmup_steps: int) -> float:
    """optax's ``linear_schedule(0, lr, warmup)`` joined to
    ``constant_schedule(lr)`` at ``warmup``, evaluated in f32."""
    if count >= warmup_steps:
        return float(np.float32(lr))
    frac = np.float32(1) - np.float32(count) / np.float32(warmup_steps)
    return float((np.float32(0) - np.float32(lr)) * frac + np.float32(lr))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in f32; 0 for no tensors."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=weight_decay))`` over ``params``, reading each
    parameter's ``.grad`` (None counts as zero)."""

    def __init__(self, params: Sequence[nn.Parameter], lr: float,
                 warmup_steps: int, grad_clip: float,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = float(global_norm(grads))
        if norm >= self.grad_clip:
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        lr = warmup_constant_lr(self.count, self.lr, self.warmup_steps)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        self.count += 1


def make_optimizer(params: Sequence[nn.Parameter], lr: float = 5e-5,
                   warmup_steps: int = 500, grad_clip: float = 5.0,
                   weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, optimizer: str = "adamw") -> AdamW:
    if optimizer != "adamw":
        raise NotImplementedError(f"optimizer {optimizer!r}: only adamw is "
                                  f"ported (adafactor: ROADMAP.md, Queue 1, "
                                  f"the optimizer and memory levers)")
    return AdamW(params, lr, warmup_steps, grad_clip, weight_decay, b1, b2)


def split_frozen(model: nn.Module, frozen: Sequence[str] = ("vae",)
                 ) -> Tuple[List[Tuple[str, nn.Parameter]],
                            List[Tuple[str, nn.Parameter]]]:
    """(trainable, frozen) named parameters: frozen are those under a
    top-level submodule named in ``frozen`` (``make_frozen_labels``)."""
    trainable, held = [], []
    for name, p in model.named_parameters():
        (held if name.split(".")[0] in frozen else trainable).append((name, p))
    return trainable, held


class TrainState:
    """The model, its optimizer over the trainable parameters, and the
    frozen names. ``step`` is ``TrainState.step`` in JAX: one more per
    update, as the optimizer's count, which it leaves only where a resume
    sets it apart (``override_lr`` starts a fresh optimizer at the run's
    step, ``override_step`` moves the step alone)."""

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 frozen: Tuple[str, ...]):
        self.model = model
        self.optimizer = optimizer
        self.frozen = frozen
        self.step = 0


def create_train_state(model: nn.Module, lr: float = 5e-5,
                       warmup_steps: int = 500, grad_clip: float = 5.0,
                       frozen: Sequence[str] = ("vae",),
                       optimizer: str = "adamw") -> TrainState:
    trainable, _ = split_frozen(model, tuple(frozen))
    opt = make_optimizer([p for _, p in trainable], lr, warmup_steps,
                         grad_clip, optimizer=optimizer)
    return TrainState(model, opt, tuple(frozen))


def make_train_step(loss: Optional[RDLoss] = None,
                    grad_accum: int = 1) -> Callable:
    """Returns step(state, batch, noise=None, generator=None) -> metrics:
    the stage-I forward and loss, the gradients, ``grad_norm`` over all of
    them, and one clipped AdamW update. ``batch["image"]``: (B, H, W, 3) in
    [-1, 1] on the model's device; ``noise`` / ``generator`` feed the
    codec's bit estimate (``LatentCodec.forward``). The lambda schedule is
    read at the optimizer's count, as ``bound_loss`` does
    (``step.py:187-188``). Metrics are python floats."""
    if loss is None:
        loss = RDLoss()
    if grad_accum != 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet "
                                  "(ROADMAP.md, Queue 1, the optimizer and "
                                  "memory levers)")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        model = state.model
        model.zero_grad(set_to_none=True)
        image = batch["image"]
        enc_dict, pred = model(image, training=True, noise=noise,
                               generator=generator)
        total, metrics = loss(image, pred, enc_dict["bpp"], step=state.step,
                              training=True)
        metrics["bpp_hard_y"] = enc_dict["bpp_hard_y"]
        total.backward()
        metrics["grad_norm"] = global_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        return {k: float(v.detach()) for k, v in metrics.items()}

    return train_step
