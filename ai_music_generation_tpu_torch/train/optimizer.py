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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element (``optax.global_norm``),
    an fp32 0-dim tensor on their device."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms).float())


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm(max_norm)``:
    unchanged when ``norm < max_norm``, else ``g / norm * max_norm``. No
    host read: the choice is made on the device."""
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm))
