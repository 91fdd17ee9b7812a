"""Train and eval steps with gradient accumulation: the port of
``ai_music_generation_tpu/train/step.py``.

The JAX step is one jitted program that scans the micro-steps, sums their
gradients in fp32 and scales the sum by 1/accum. Here the micro-steps are a
Python loop of ``backward()`` calls on the unscaled loss: autograd sums
each micro-step's gradients into ``.grad`` in the same order, and the sum
is then scaled by 1/accum, as in JAX. Nothing is read back to the host:
the metrics are device tensors (and the lr, a Python float).

On a mesh (``plan``, ``parallel/sharding.py::parallelize``) the forward
goes through the plan's module (DDP or FSDP2 over the data axis), the
micro-steps before the last do not sync their gradients, and each rank's
loss is its share of the global mean (``models/gpt.py::
cross_entropy_ignore_index``), so the data-axis mean of the gradients that
DDP and FSDP2 take is the single-card mean over the global batch; the grad
norm is the whole parameter set's and the loss the data-axis mean.

While a profiler records, the step opens the spans of ``utils/tracing.py``:
``train.forward`` and ``train.backward`` for each micro-step's forward and
its ``backward()`` call, ``train.clip`` over the gradients' scale, norm and
clip, ``train.optimizer`` over the lr, ``optimizer.step()`` and
``zero_grad``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from torch.distributed.tensor import DTensor

from ai_music_generation_tpu_torch.models.gpt import GPT, dropout_key
from ai_music_generation_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    global_norm,
)
from ai_music_generation_tpu_torch.utils import tracing


def make_train_step(model: GPT, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    grad_clip: Optional[float] = 1.0, plan=None) -> Callable:
    """Build ``train_step(x, y, step, seed=0) -> metrics``.

    x, y: [grad_accum, micro_batch, T] integer tensors on the model's
    device. ``step`` is the step index: the schedule's argument (JAX
    ``TrainState.step``) and, with ``seed``, the dropout masks' key (micro
    step i of step s drops with ``dropout_key(seed, s, i)``). The loss and
    the gradients are means over the micro-steps; the gradients are
    clipped to ``grad_clip`` (None or 0: no clip) after ``grad_norm`` is
    taken. metrics: ``loss`` and ``grad_norm`` (fp32 0-dim tensors) and
    ``lr``. On a mesh (``plan``) x and y are this rank's rows of the
    global batch and the metrics the global ones (module docstring)."""
    params = list(model.parameters())
    forward = model if plan is None else plan.module
    groups = None if plan is None else plan.norm_groups(model)

    def train_step(x: torch.Tensor, y: torch.Tensor, step: int,
                   seed: int = 0) -> dict:
        model.train()
        accum = x.shape[0]
        loss = None
        for i in range(accum):
            sync = plan is None or i == accum - 1
            with contextlib.nullcontext() if sync else plan.no_sync():
                with tracing.span(tracing.TRAIN_FORWARD):
                    _, micro = forward(x[i], y[i],
                                       dropout_key=dropout_key(seed, step, i))
                with tracing.span(tracing.TRAIN_BACKWARD):
                    micro.backward()
            loss = micro.detach() if loss is None else loss + micro.detach()
        grads = [p.grad for p in params]
        with tracing.span(tracing.TRAIN_CLIP):
            if accum > 1:  # the fast path (accum 1) scales by nothing
                torch._foreach_mul_([_local(g) for g in grads], 1.0 / accum)
                loss = loss * (1.0 / accum)
            if plan is not None:
                loss = plan.data_mean(loss)
            grad_norm = global_norm(grads, groups)
            if grad_clip:
                clip_by_global_norm_(grads, grad_clip, grad_norm)
        with tracing.span(tracing.TRAIN_OPTIMIZER):
            lr = (schedule(step) if schedule is not None
                  else optimizer.param_groups[0]["lr"])
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr}

    return train_step


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def make_eval_step(model: GPT, plan=None) -> Callable:
    """``eval_step(x, y) -> loss``: the mean loss in ``eval()`` mode (no
    dropout), without gradients; on a mesh (``plan``) of this rank's rows,
    the global mean."""
    forward = model if plan is None else plan.module

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.eval()
        loss = forward(x, y)[1]
        return loss if plan is None else plan.data_mean(loss)

    return eval_step
