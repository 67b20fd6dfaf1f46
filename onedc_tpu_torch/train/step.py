"""Stage-I training step: optimizer, schedule, step function.

JAX counterpart: ``onedc_tpu/train/step.py`` (:29-94 ``make_optimizer``,
``make_frozen_labels``, ``make_masked_optimizer``, ``create_train_state``;
:97-145 ``grad_accum_scan``; :148-238 ``make_train_step`` and the stage-I
loss with the Codeformer's terms and ``remat``; :241-367
``make_unrolled_accum_step``, whose micro-batch arithmetic is the scan's;
its ``micro_grads_dtype`` / ``accum_dtype`` levers, which no trainer sets,
are not ported). What it reproduces of optax, rule for rule (Adafactor's
rules: ``Adafactor``):

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
  weight gradients included; the VAE encoder and the VQGAN run with no
  autograd record (their outputs are detached, ``stop_gradient`` in JAX),
  so their gradients are zero there and absent here.

The step updates the parameters in place (torch's way; the JAX state is
immutable). Gradients are cleared at the start of a step, not its end, so
the caller can read them after it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.fsdp import all_reduce_mean_, local, shard_info, \
    sharded_like
from .losses import RDLoss


def warmup_constant_lr(count: int, lr: float, warmup_steps: int) -> float:
    """optax's ``linear_schedule(0, lr, warmup)`` joined to
    ``constant_schedule(lr)`` at ``warmup``, evaluated in f32."""
    if count >= warmup_steps:
        return float(np.float32(lr))
    frac = np.float32(1) - np.float32(count) / np.float32(warmup_steps)
    return float((np.float32(0) - np.float32(lr)) * frac + np.float32(lr))


def _norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in f32; 0 for no tensors. FSDP's sharded tensors (DTensors) count
    whole: their shards' sums of squares are all-reduced over their
    group."""
    if not tensors:
        return torch.zeros(())
    sharded = [t for t in tensors if shard_info(t) is not None]
    if not sharded:
        return _norm(tensors)
    sq = _norm([local(t) for t in sharded]).square()
    group = shard_info(sharded[0])[1]
    if dist.get_world_size(group) > 1:
        dist.all_reduce(sq, group=group)
    plain = [t for t in tensors if shard_info(t) is None]
    if plain:
        sq = sq + _norm(plain).square()
    return sq.sqrt()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                         ) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g / norm * max_norm`` when the
    norm reaches ``max_norm``, the gradients as they are below it; each
    rank's shards of FSDP's gradients (``local``)."""
    norm = float(global_norm(grads))
    grads = [local(g) for g in grads]
    if norm >= max_norm:
        grads = torch._foreach_div(grads, norm)
        torch._foreach_mul_(grads, max_norm)
    return grads


def _grads(params: Sequence[nn.Parameter]) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def _like_param(state: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A state tensor of ``p``'s shape for the checkpoint: as it is, or
    under FSDP a DTensor view of this rank's shard, split as ``p``."""
    info = shard_info(p)
    return state if info is None else sharded_like(state, p, info[0],
                                                   p.shape)


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=weight_decay))`` over ``params``, reading each
    parameter's ``.grad`` (None counts as zero)."""

    name = "adamw"

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
        self.mu = [torch.zeros_like(local(p)) for p in self.params]
        self.nu = [torch.zeros_like(local(p)) for p in self.params]

    def named_state(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The live state tensors by checkpoint key: ``adamw/mu/<name>``
        and ``adamw/nu/<name>`` for the parameter of each name."""
        out = {}
        for name, p, mu, nu in zip(names, self.params, self.mu, self.nu):
            out[f"adamw/mu/{name}"] = _like_param(mu, p)
            out[f"adamw/nu/{name}"] = _like_param(nu, p)
        return out

    @torch.no_grad()
    def step(self) -> None:
        grads = clip_by_global_norm(_grads(self.params), self.grad_clip)
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
        params = [local(p) for p in self.params]
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        lr = warmup_constant_lr(self.count, self.lr, self.warmup_steps)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.count += 1


# optax.adafactor's defaults, which the JAX package keeps
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest) by ``np.argsort``, if the second largest has at least
    ``ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR`` elements; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _without(shape: Sequence[int], axis: int) -> Tuple[int, ...]:
    return tuple(n for i, n in enumerate(shape) if i != axis)


class Adafactor:
    """``optax.chain(clip_by_global_norm(grad_clip), adafactor(schedule,
    multiply_by_parameter_scale=False, weight_decay_rate=weight_decay or
    None))`` over ``params`` (``onedc_tpu/train/step.py:29-49``), rule for
    rule from optax 0.2.6 (``_src/factorized.py``, ``_src/alias.py``):

    - second-moment decay ``1 - (count + 1) ** -0.8``, on ``grad² + 1e-30``;
    - a parameter whose second-largest axis has at least 128 elements keeps
      a row and a column EMA over its two largest axes (``factored_dims``)
      and is scaled by ``(v_row / mean(v_row)) ** -0.5`` times ``v_col **
      -0.5``; any other keeps a full ``v`` and is scaled by ``v ** -0.5``;
    - ``clip_by_block_rms(1.0)`` per parameter, then the warmup-constant
      learning rate at the optimizer's count (count 0 moves nothing), then
      ``weight_decay * p``, added unscaled by the learning rate, as optax's
      chain adds it.

    The port's layouts are OIHW and (out, in) where flax's are HWIO and
    (in, out): the factored pair is the same two logical axes, with the row
    and column roles swapped. In exact arithmetic the estimate is the same
    (``mean(v_row) == mean(v_col)``), so the updates agree with optax's to
    f32 rounding, not bit for bit.
    """

    name = "adafactor"

    def __init__(self, params: Sequence[nn.Parameter], lr: float,
                 warmup_steps: int, grad_clip: float,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.count = 0
        self.dims = [factored_dims(tuple(p.shape)) for p in self.params]
        # per parameter: (v_row, v_col) where factored, else (v,); under
        # FSDP each of this rank's shard (a moment that averages over the
        # sharded dim is whole on every rank)
        self.v: List[Tuple[torch.Tensor, ...]] = []
        for p, dims in zip(self.params, self.dims):
            shard = local(p)
            if dims is None:
                self.v.append((torch.zeros_like(shard),))
            else:
                d1, d0 = dims
                self.v.append((shard.new_zeros(_without(shard.shape, d0)),
                               shard.new_zeros(_without(shard.shape, d1))))

    def named_state(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The live state tensors by checkpoint key: ``adafactor/v_row/
        <name>`` and ``adafactor/v_col/<name>`` of a factored parameter,
        ``adafactor/v/<name>`` of any other."""
        out = {}
        for name, p, v, dims in zip(names, self.params, self.v, self.dims):
            if dims is None:
                out[f"adafactor/v/{name}"] = _like_param(v[0], p)
                continue
            info = shard_info(p)
            for key, t, gone in zip(("v_row", "v_col"), v, dims[::-1]):
                if info is not None and info[0] != gone:
                    t = sharded_like(t, p, info[0] - (info[0] > gone),
                                     _without(p.shape, gone))
                out[f"adafactor/{key}/{name}"] = t
        return out

    @torch.no_grad()
    def step(self) -> None:
        grads = clip_by_global_norm(_grads(self.params), self.grad_clip)
        t = np.float32(self.count + 1)
        decay = np.float32(1) - t ** np.float32(-ADAFACTOR_DECAY_RATE)
        lr = warmup_constant_lr(self.count, self.lr, self.warmup_steps)
        device = self.params[0].device if self.params else None
        keep, take, lr = (torch.tensor(x, dtype=torch.float32, device=device)
                          for x in (decay, np.float32(1) - decay, lr))
        for p, g, v, dims in zip(self.params, grads, self.v, self.dims):
            info = shard_info(p)
            sdim, group = info if info is not None else (None, None)
            g2 = g * g + ADAFACTOR_EPS
            if dims is None:
                (v_full,) = v
                v_full.copy_(keep * v_full + take * g2)
                u = g * v_full.rsqrt()
            else:
                d1, d0 = dims
                v_row, v_col = v
                v_row.copy_(keep * v_row + take * _mean(g2, d0, sdim == d0,
                                                        group, p.shape[d0]))
                v_col.copy_(keep * v_col + take * _mean(g2, d1, sdim == d1,
                                                        group, p.shape[d1]))
                row_mean = _mean(v_row, d1 - 1 if d1 > d0 else d1,
                                 sdim == d1, group, p.shape[d1],
                                 keepdim=True)
                u = g * (v_row / row_mean).rsqrt().unsqueeze(d0) \
                    * v_col.rsqrt().unsqueeze(d1)
            del g2
            rms = _mean(u.pow(2), None, sdim is not None, group,
                        p.numel()).sqrt()
            u = lr * (u / torch.clamp_min(rms / ADAFACTOR_CLIPPING_THRESHOLD,
                                          1.0))
            shard = local(p)
            if self.weight_decay:
                u = u + self.weight_decay * shard
            shard.sub_(u)
        self.count += 1


def _mean(t: torch.Tensor, dim: Optional[int], sharded: bool, group,
          n: int, keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)`` (``dim`` None: of every element) of a tensor whose
    reduced dim (any, for None) is split over ``group`` when ``sharded``:
    the shards' sums all-reduced, over ``n``, the whole's count."""
    if not sharded or dist.get_world_size(group) == 1:
        return t.mean() if dim is None else t.mean(dim, keepdim=keepdim)
    total = t.sum() if dim is None else t.sum(dim, keepdim=keepdim)
    dist.all_reduce(total, group=group)
    return total / n


def make_optimizer(params: Sequence[nn.Parameter], lr: float = 5e-5,
                   warmup_steps: int = 500, grad_clip: float = 5.0,
                   weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, optimizer: str = "adamw"):
    """AdamW (the reference's: two f32 moments per parameter) or Adafactor
    (factored second moments: a row and a column per large parameter) with
    the same schedule and clip."""
    if optimizer == "adafactor":
        return Adafactor(params, lr, warmup_steps, grad_clip, weight_decay)
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}: adamw or "
                         f"adafactor")
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

    def __init__(self, model: nn.Module, optimizer: Union[AdamW, Adafactor],
                 frozen: Tuple[str, ...]):
        self.model = model
        self.optimizer = optimizer
        self.frozen = frozen
        self.step = 0
        # over more than one rank (``data_parallel``): what a step calls
        # (the model, or its DDP wrapper), the data group whose ranks
        # average the metrics, and the parameters outside FSDP's shards
        # whose gradients the step all-reduces
        self.runner: nn.Module = model
        self.group: Optional[dist.ProcessGroup] = None
        self.replicated: List[nn.Parameter] = []

    def sync_gradients(self) -> None:
        """The mean over the data ranks of the gradients that neither DDP
        nor FSDP reduces (``replicated``)."""
        all_reduce_mean_([p.grad for p in self.replicated], self.group)

    def mean_over_ranks(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Each scalar metric's mean over the data ranks, in one
        all-reduce: a rank's metrics are the means over its own rows."""
        if self.group is None or dist.get_world_size(self.group) == 1:
            return metrics
        keys = sorted(metrics)
        device = next(self.model.parameters()).device  # the group's
        flat = torch.stack([metrics[k].float().to(device) for k in keys])
        all_reduce_mean_([flat], self.group)
        return dict(zip(keys, flat.unbind()))


def create_train_state(model: nn.Module, lr: float = 5e-5,
                       warmup_steps: int = 500, grad_clip: float = 5.0,
                       frozen: Sequence[str] = ("vae",),
                       optimizer: str = "adamw") -> TrainState:
    trainable, _ = split_frozen(model, tuple(frozen))
    opt = make_optimizer([p for _, p in trainable], lr, warmup_steps,
                         grad_clip, optimizer=optimizer)
    return TrainState(model, opt, tuple(frozen))


def create_stage2_states(onedc: nn.Module, guidance: nn.Module,
                         gen_lr: float = 1e-6, guid_lr: float = 1e-6,
                         warmup_steps: int = 500, grad_clip: float = 10.0,
                         optimizer: str = "adamw"
                         ) -> Tuple[TrainState, TrainState]:
    """The stage-II pair (JAX ``trainer_stage2.py:create_stage2_states``
    :40): the generator's state with ``vae`` and ``codec`` frozen (the
    one-step UNet trains) and the guidance's with ``real_unet`` frozen (the
    fake UNet and the GAN head train), each AdamW or Adafactor with the
    same schedule and clip. The frozen parts stop requiring gradients: no
    turn differentiates them (JAX differentiates only the state being
    updated), so they hold no autograd record."""
    gen = create_train_state(onedc, gen_lr, warmup_steps, grad_clip,
                             frozen=("vae", "codec"), optimizer=optimizer)
    guid = create_train_state(guidance, guid_lr, warmup_steps, grad_clip,
                              frozen=("real_unet",), optimizer=optimizer)
    for state in (gen, guid):
        for _, p in split_frozen(state.model, state.frozen)[1]:
            p.requires_grad_(False)
    return gen, guid


def make_train_step(loss: Optional[RDLoss] = None, grad_accum: int = 1,
                    remat: bool = False,
                    codeformer_loss_weight: float = 1e-3,
                    codeformer_mse_weight: float = 1e-2) -> Callable:
    """Returns step(state, batch, noise=None, generator=None) -> metrics:
    the stage-I forward and loss, the gradients, ``grad_norm`` over all of
    them, and one clipped optimizer update. ``batch["image"]``: (B, H, W,
    3) in [-1, 1] on the model's device; ``noise`` (``OneDC.bit_noise``'s
    shape, the whole batch's) or ``generator`` feed the codec's bit
    estimate, the noise drawn for the whole batch before the first
    forward. The lambda schedule is read at the optimizer's count, as
    ``bound_loss`` does (``step.py:187-188``). Metrics are python floats.

    ``grad_accum`` N > 1 (JAX's ``grad_accum_scan`` :97-145 and
    ``make_unrolled_accum_step`` :241-367, which compute the same; here
    both are one host loop): the batch, which must divide by N, runs as N
    micro-batches of consecutive rows, micro-batch i on its own rows of the
    noise; the gradients sum into ``.grad`` in f32 (JAX's accumulator
    dtype for f32 parameters), are multiplied by f32(1/N), and the metrics
    are averaged alike; ``grad_norm`` is that of the mean gradients.
    ``remat``: the model's forward rematerialised (``utils/remat.py``).
    With the Codeformer the distillation adds ``(ce + mse *
    codeformer_mse_weight) * codeformer_loss_weight`` to the loss
    (``_make_stage1_loss_fn`` :225-236)."""
    if loss is None:
        loss = RDLoss()
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_fn(model, image, opt_step: int, noise):
        enc_dict, pred = model(image, training=True, noise=noise,
                               remat=remat)
        total, metrics = loss(image, pred, enc_dict["bpp"], step=opt_step,
                              training=True)
        metrics["bpp_hard_y"] = enc_dict["bpp_hard_y"]
        if "code_ce_loss" in enc_dict:
            ce = enc_dict["code_ce_loss"]
            mse = enc_dict["code_mse_loss"]
            cf = ce + mse * codeformer_mse_weight
            weighted = cf * codeformer_loss_weight
            total = total + weighted
            metrics.update(codeformer_ce_loss=ce, codeformer_mse_loss=mse,
                           codeformer_loss=cf,
                           weighted_codeformer_loss=weighted,
                           total_loss=total)
        return total, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        model = state.model
        model.zero_grad(set_to_none=True)
        image = batch["image"]
        b = image.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum "
                             f"{grad_accum}")
        if noise is None and generator is not None:
            noise = model.bit_noise(image, generator)
        micro = b // grad_accum
        sums: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum):
            rows = slice(i * micro, (i + 1) * micro)
            total, metrics = loss_fn(state.runner, image[rows], state.step,
                                     None if noise is None else noise[rows])
            total.backward()
            for key, value in metrics.items():
                value = value.detach()
                sums[key] = sums[key] + value if key in sums else value
            del total, metrics
        state.sync_gradients()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if grad_accum > 1:
            inv = float(np.float32(1.0 / grad_accum))
            torch._foreach_mul_([local(g) for g in grads], inv)
            sums = {k: v * inv for k, v in sums.items()}
        sums = state.mean_over_ranks(sums)
        sums["grad_norm"] = global_norm(grads)
        state.optimizer.step()
        state.step += 1
        return {k: float(v) for k, v in sums.items()}

    return train_step
