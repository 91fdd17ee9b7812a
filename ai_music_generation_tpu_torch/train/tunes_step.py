"""TunesFormer train and eval steps: the port of
``ai_music_generation_tpu/train/tunes_step.py``
(``make_tunesformer_train_step`` and ``make_tunesformer_eval_step``, JAX
:28-63).

The train step carries the reference trainer's NaN-loss guard (ref:
tunesformer/train.py:95-96,134-135; JAX :48-54): a non-finite loss leaves
the parameters and the whole optimizer state as they were, the count of
applied updates included, so the schedule is read at the number of
accepted updates. The guard is decided on the device (the fused AdamW's
``found_inf``): the step reads nothing back to the host.

Not ported: ``shard_tunesformer_step`` (the (data, model) mesh and tensor
parallelism), which waits for the sharded rules of ROADMAP.md item 6.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ai_music_generation_tpu_torch.models.gpt import dropout_key
from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.train.optimizer import adamw_count


def make_tunesformer_train_step(
        model: TunesFormer, optimizer: torch.optim.AdamW,
        schedule: Callable[[torch.Tensor], torch.Tensor]) -> Callable:
    """Build ``train_step(batch, step, seed=0, patch_indices=None) ->
    loss``.

    batch: [B, P, S] integer patch stacks on the model's device;
    patch_indices: optional [B, K] conditioning rows (the reference's
    PATCH_SAMPLING_BATCH_SIZE subsample). ``step`` and ``seed`` key the
    dropout masks (``dropout_key(seed, step)``: the JAX CLI's
    ``fold_in(PRNGKey(seed), step_count)``); the lr is
    ``schedule(adamw_count(optimizer))``, optax's schedule at its count
    (``optimizer`` from ``train/optimizer.py::optax_adamw``). Returns
    the loss, an fp32 0-dim tensor (non-finite when the update was
    skipped)."""

    def train_step(batch: torch.Tensor, step: int, seed: int = 0,
                   patch_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        model.train()
        loss = model(batch, patch_indices,
                     dropout_key=dropout_key(seed, step))
        loss.backward()
        found_inf = (~torch.isfinite(loss)).to(torch.float32)
        optimizer.param_groups[0]["lr"] = schedule(adamw_count(optimizer))
        optimizer.found_inf = found_inf
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


def make_tunesformer_eval_step(model: TunesFormer) -> Callable:
    """``eval_step(batch) -> loss``: the mean loss in ``eval()`` mode (no
    dropout), without gradients."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(batch)

    return eval_step
