"""Sequence (context) parallelism for GPT training: the port of
``ai_music_generation_tpu/parallel/sequence.py``.

The TOKEN axis of the batch is split over a mesh ``seq`` axis: rank i holds
the contiguous global positions ``i*Tl .. (i+1)*Tl - 1`` of its data
shard's rows. The blocks' positionwise work (LN, MLP, embeddings, head,
loss) runs locally, and attention rotates K/V chunks around the seq group
(``ops/ring_attention.py``). As in JAX, the model's own modules run the
chunk (``GPTConfig.seq_axis`` switches attention to the ring and offsets the
positions), and the loss sums its total and its token count over both mesh
axes, so targets ignored unevenly across the ranks still give the global
mean.

The parameters are replicated; after the backward their gradients are
summed over the mesh, as JAX's ``shard_map`` transpose sums the gradients
of replicated inputs. Numerical contract (tests/test_torch_sequence.py):
the loss and every gradient match the plain single-device step to fp32
tolerance.

Scope: the training path, as in JAX (decode keeps the data/model axes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ai_music_generation_tpu_torch.models.gpt import GPT
from ai_music_generation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Layout,
)
from ai_music_generation_tpu_torch.train.optimizer import global_norm


def make_seq_mesh(n_data: int = 1, n_seq: int = 1,
                  device: str = "cuda") -> DeviceMesh:
    """A (data, seq) ``DeviceMesh`` over the process group's ranks, rank r
    at (r // n_seq, r % n_seq): ``seq`` is the minor axis, so the ring's
    hops go between neighbouring ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: start under torchrun and call "
            "parallel.distributed.initialize_distributed() first")
    world = dist.get_world_size()
    if n_data * n_seq != world:
        raise ValueError(f"mesh {n_data}x{n_seq} != {world} processes")
    return init_device_mesh(torch.device(device).type, (n_data, n_seq),
                            mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def _seq_model(model: GPT, mesh: DeviceMesh) -> GPT:
    """``model`` as its sequence-parallel self, in place: the config takes
    ``seq_axis`` and every module with a ``layout`` the mesh's (no
    parameter is split)."""
    cfg = model.config
    if cfg.dropout != 0.0:
        raise ValueError(
            "sequence-parallel training path requires dropout=0 "
            "(attention-prob dropout is not expressible under ring "
            "attention)")
    if cfg.n_expert != 0:
        raise ValueError(
            "MoE under sequence parallelism needs cross-shard routing stats; "
            "use the dp/tp/fsdp paths for MoE models (parallel/mesh.py)")
    seq_cfg = dataclasses.replace(cfg, seq_axis=SEQ_AXIS)
    layout = Layout(mesh)
    for m in model.modules():
        if hasattr(m, "config") and m.config is cfg:
            m.config = seq_cfg
        if hasattr(type(m), "layout"):
            m.layout, m.split = layout, frozenset()
    return model


def make_seq_loss(model: GPT, mesh: DeviceMesh) -> Callable:
    """``loss(x, y) -> (share, loss)`` with x, y the GLOBAL [B, T] batch on
    every rank: the rank runs its rows of the data axis and its positions of
    the seq axis. ``share`` is the rank's part of the global mean (the
    value to call ``backward`` on: the sum of the ranks' gradients over the
    mesh is the global mean's), ``loss`` the global mean itself (detached,
    equal on every rank). ``model`` becomes sequence-parallel in place."""
    cfg = model.config
    _seq_model(model, mesh)
    layout = model.layout

    def loss_fn(x: torch.Tensor, y: torch.Tensor):
        B, T = x.shape
        if T % layout.n_seq:
            raise ValueError(
                f"T {T} not divisible by {layout.n_seq} seq shards")
        # the model's own block_size check sees only the local chunk
        if T > cfg.block_size:
            raise ValueError(
                f"global sequence {T} exceeds block_size {cfg.block_size}")
        rows, cols = B // layout.n_data, T // layout.n_seq
        mine = (slice(layout.data_rank * rows, (layout.data_rank + 1) * rows),
                slice(layout.seq_rank * cols, (layout.seq_rank + 1) * cols))
        _, share = model(x[mine], y[mine])
        return share, _mesh_sum(share.detach().clone(), layout)

    return loss_fn


def _mesh_sum(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """``t`` summed over the seq and data groups, in place."""
    for group in (layout.seq_group, layout.data_group):
        dist.all_reduce(t, group=group)
    return t


def make_seq_train_step(model: GPT, optimizer: torch.optim.Optimizer,
                        mesh: DeviceMesh,
                        schedule: Optional[Callable[[int], float]] = None
                        ) -> Callable:
    """Build ``step(x, y) -> metrics`` over the global [B, T] batch: the
    loss of :func:`make_seq_loss`, its backward, the gradients summed over
    the mesh (every rank then holds the global gradients), the optimizer's
    update of the replicated parameters. metrics: ``loss``, ``grad_norm``
    (``optax.global_norm`` of the gradients) and, with ``schedule``, ``lr``
    (``schedule`` of the step count, set as every group's lr). JAX's
    accum-1 fast path; the step count starts at 0."""
    loss_fn = make_seq_loss(model, mesh)
    layout = model.layout
    params = [p for p in model.parameters() if p.requires_grad]
    count = [0]

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.train()
        share, loss = loss_fn(x, y)
        share.backward()
        grads = [p.grad for p in params]
        sum_grads_(grads, layout)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        if schedule is not None:
            metrics["lr"] = schedule(count[0])
            for group in optimizer.param_groups:
                group["lr"] = metrics["lr"]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        count[0] += 1
        return metrics

    return step


def sum_grads_(grads: list, layout: Layout) -> None:
    """Sum the gradients ``grads`` over the seq and data groups of
    ``layout``, in place (one flat collective a group)."""
    flat = _mesh_sum(torch.cat([g.reshape(-1) for g in grads]), layout)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
