"""Optimizer, LR schedule and gradient clip: the port of
``ai_music_generation_tpu/train/optimizer.py`` (and, through it, of
nanoGPT's train.py / model.py behaviour).

- Cosine schedule with linear warmup and a min-LR floor, a plain function
  of the iteration.
- AdamW with weight decay on the rank >= 2 parameters only (matmul weights
  and both embeddings, the tied head counted once), none on biases and
  LayerNorm: the JAX mask ``p.ndim >= 2``. ``eps=1e-8``. The caller sets
  each group's ``lr`` from the schedule at the step index before each step,
  as optax evaluates it at its update count.
- Global-norm clipping as ``optax.clip_by_global_norm`` computes it: the
  gradients are scaled only when the norm is not below the limit, each as
  ``g / norm * max_norm`` (``torch.nn.utils.clip_grad_norm_`` scales by
  ``max / (norm + 1e-6)``, which drifts from it).

TunesFormer training (``cli/tunesformer_train.py``) uses others:
:func:`hf_cosine_schedule` (HF's ``get_scheduler("cosine")`` as the JAX CLI
computes it, on the device) and :func:`optax_adamw` (``optax.adamw`` at
optax's defaults: weight decay 1e-4 on every parameter, no clip), whose
step can be skipped on the device (the NaN guard).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def cosine_warmup_schedule(learning_rate: float, warmup_iters: int,
                           lr_decay_iters: int,
                           min_lr: float) -> Callable[[int], float]:
    """The reference LR curve:

    1. linear warmup: lr * (it + 1) / (warmup_iters + 1)
    2. cosine decay from lr to min_lr over [warmup_iters, lr_decay_iters]
    3. constant min_lr after lr_decay_iters
    """

    def schedule(it: int) -> float:
        if it < warmup_iters:
            return learning_rate * (it + 1) / (warmup_iters + 1)
        if it > lr_decay_iters:
            return min_lr
        ratio = min(max((it - warmup_iters)
                        / max(lr_decay_iters - warmup_iters, 1), 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        return min_lr + coeff * (learning_rate - min_lr)

    return schedule


def decay_groups(model: torch.nn.Module) -> tuple[list, list]:
    """(decayed, not decayed) parameters in ``model.parameters()`` order
    (each tensor once, so the tied head is not listed twice)."""
    params = list(model.parameters())
    return ([p for p in params if p.dim() >= 2],
            [p for p in params if p.dim() < 2])


def make_optimizer(model: torch.nn.Module, learning_rate: float = 6e-4,
                   weight_decay: float = 0.1, beta1: float = 0.9,
                   beta2: float = 0.95) -> torch.optim.AdamW:
    """AdamW over nanoGPT's two groups (group 0 decayed, group 1 not), the
    fused implementation on the card."""
    decay, nodecay = decay_groups(model)
    fused = decay[0].device.type == "cuda"
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": nodecay, "weight_decay": 0.0}],
        lr=learning_rate, betas=(beta1, beta2), eps=1e-8, fused=fused)


def global_norm(tensors: Iterable[torch.Tensor],
                groups: Optional[list] = None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element (``optax.global_norm``),
    an fp32 0-dim tensor on their device.

    On a mesh the tensors are this rank's parts (local tensors, or FSDP
    DTensors, whose local shards are read) and ``groups[i]`` is the process
    group that tensor i is split over (None: whole here): each group's sum
    of squares is summed over it, so the norm is that of the whole
    parameter set, the same on every rank."""
    tensors = [t.to_local() if isinstance(t, DTensor) else t
               for t in tensors]
    norms = torch._foreach_norm(tensors)
    if groups is None:
        return torch.linalg.vector_norm(torch.stack(norms).float())
    # one sum a group, in the order the groups first appear (the same on
    # every rank: it follows the parameters' names)
    sums: dict[int, list] = {}
    for norm, group in zip(norms, groups):
        sums.setdefault(id(group), [group, []])[1].append(norm)
    total = None
    for group, part in sums.values():
        sq = torch.linalg.vector_norm(torch.stack(part).float()) ** 2
        if group is not None:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return total.sqrt()


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm(max_norm)``:
    unchanged when ``norm < max_norm``, else ``g / norm * max_norm``. No
    host read: the choice is made on the device. ``grads`` may be FSDP
    DTensors: their local shards are scaled."""
    grads = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm))


def hf_cosine_schedule(lr: float, num_warmup: float, num_training: float
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """HF ``get_scheduler("cosine")`` as JAX cli/tunesformer_train.py:88-100
    computes it: linear warmup from 0 over ``num_warmup`` steps (a float),
    then a cosine to 0 at ``num_training``. The returned function takes the
    step as a tensor and gives the lr as an fp32 0-dim tensor on its device,
    each operation in fp32 with the JAX function's Python-side constants,
    so no value is read back to the host."""
    warm_div = max(num_warmup, 1)
    cos_div = max(num_training - num_warmup, 1)

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * torch.clamp(step / warm_div, max=1.0)
        progress = torch.clamp((step - num_warmup) / cos_div, 0.0, 1.0)
        cos = lr * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return torch.where(step < num_warmup, warm, cos)

    return fn


# optax.adamw's defaults (optax 0.2.6)
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def optax_adamw(params: Iterable[torch.Tensor],
                weight_decay: float = ADAMW_WEIGHT_DECAY
                ) -> torch.optim.AdamW:
    """``optax.adamw`` at optax 0.2.6's defaults (b1 0.9, b2 0.999, eps
    1e-8, ``weight_decay`` on every parameter, no mask) as torch's fused
    AdamW: the same update (``-lr * (m_hat / (sqrt(v_hat) + eps) + wd *
    p)``, bias corrections at the count after the update) in another order
    of roundings, one group, each ``step`` an fp32 tensor on its
    parameter's device.

    The caller sets the group's ``lr`` to a tensor on the parameters'
    device (the schedule at :func:`adamw_count`) and ``found_inf``, an fp32
    0-dim tensor, on the optimizer before :meth:`step`: at 1 the fused
    kernel skips the update and the step counts are taken back, so the
    parameters, moments and counts stay as they were, as optax's state
    does under the JAX step's NaN guard. Nothing is read to the host."""
    return torch.optim.AdamW(params, lr=0.0, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=weight_decay,
                             fused=True)


def adamw_count(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """The number of applied updates (optax's ``count``): the first
    parameter's ``step``, or a 0 on its device before the first step."""
    p = optimizer.param_groups[0]["params"][0]
    state = optimizer.state.get(p)
    if state:
        return state["step"]
    return torch.zeros((), dtype=torch.float32, device=p.device)
