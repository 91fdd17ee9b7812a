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

:func:`shard_tunesformer_step` (JAX :66-110) runs both over a (data,
model) mesh: the parameters split over the model axis by the JAX rules
(``parallel/mesh.py``: column-parallel ``c_attn``, ``c_fc`` and patch
embedding, row-parallel projections, vocab-split ``char_wte``), the batch
over the data axis (DDP: the JAX step has no FSDP), the losses the global
means.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ai_music_generation_tpu_torch.models.gpt import dropout_key
from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.parallel.mesh import Layout
from ai_music_generation_tpu_torch.parallel.sharding import parallelize
from ai_music_generation_tpu_torch.train.optimizer import (
    adamw_count,
    optax_adamw,
)


def make_tunesformer_train_step(
        model: TunesFormer, optimizer: torch.optim.AdamW,
        schedule: Callable[[torch.Tensor], torch.Tensor],
        plan=None) -> Callable:
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
    skipped). On a mesh (``plan``) the batch is this rank's rows and the
    loss the global mean (``train/step.py``)."""
    forward = model if plan is None else plan.module

    def train_step(batch: torch.Tensor, step: int, seed: int = 0,
                   patch_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        model.train()
        loss = forward(batch, patch_indices,
                       dropout_key=dropout_key(seed, step))
        loss.backward()
        if plan is not None:
            loss = plan.data_mean(loss)
        found_inf = (~torch.isfinite(loss)).to(torch.float32)
        optimizer.param_groups[0]["lr"] = schedule(adamw_count(optimizer))
        optimizer.found_inf = found_inf
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


def make_tunesformer_eval_step(model: TunesFormer, plan=None) -> Callable:
    """``eval_step(batch) -> loss``: the mean loss in ``eval()`` mode (no
    dropout), without gradients; on a mesh of this rank's rows, the global
    mean."""
    forward = model if plan is None else plan.module

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> torch.Tensor:
        model.eval()
        loss = forward(batch)
        return loss if plan is None else plan.data_mean(loss)

    return eval_step


def shard_tunesformer_step(mesh, model: TunesFormer,
                           schedule: Callable[[torch.Tensor], torch.Tensor],
                           optimizer_state: Optional[dict] = None):
    """Split ``model`` (whole, the same on every rank) over ``mesh`` (a
    (data, model) ``DeviceMesh``, ``parallel/mesh.py::make_mesh``) in place
    and build its steps: JAX's contract, ``(train_step, eval_step, model,
    optimizer, plan)``. ``train_step(batch, step, seed=0,
    patch_indices=None)`` and ``eval_step(batch)`` take the global batch
    and run this rank's rows (``plan.batch_placements``: dim 0 over data,
    replicated over model), returning the global loss; ``optimizer`` is
    ``optax_adamw`` over this rank's parts, with ``optimizer_state`` (a
    whole ``state_dict`` of ``optax_adamw`` over the unsplit model) loaded
    into them; the plan (``parallel/sharding.py::MeshPlan``) gathers the
    whole state back for a checkpoint."""
    layout = Layout(mesh)
    _, plan = parallelize(model, layout)
    optimizer = optax_adamw(model.parameters())
    if optimizer_state is not None:
        plan.load_optimizer_state(model, optimizer, optimizer_state)
    step = make_tunesformer_train_step(model, optimizer, schedule, plan)
    evaluate = make_tunesformer_eval_step(model, plan)

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.chunk(layout.n_data, dim=0)[layout.data_rank]

    def train_step(batch: torch.Tensor, step_count: int, seed: int = 0,
                   patch_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        return step(rows(batch), step_count, seed,
                    None if patch_indices is None else rows(patch_indices))

    def eval_step(batch: torch.Tensor) -> torch.Tensor:
        return evaluate(rows(batch))

    return train_step, eval_step, model, optimizer, plan
