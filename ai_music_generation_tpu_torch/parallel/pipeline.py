"""GPipe-style pipeline parallelism for GPT training: the port of
``ai_music_generation_tpu/parallel/pipeline.py``.

The transformer STACK is split over a ``pipe`` mesh axis: each stage (one
process) owns ``n_layer / n_stages`` consecutive port ``Block`` s
(:class:`PipelineGPT`), microbatches flow from stage to stage with
:func:`~ai_music_generation_tpu_torch.parallel.collectives.ring_shift`, and
the schedule is JAX's GPipe loop as JAX writes it (its :141-187):

- M + S - 1 ticks for M microbatches over S stages;
- stage 0 injects ``emb[min(t, M - 1)]``, the others take the activation
  the ring brought; every stage computes on every tick (the bubbles compute
  on stale activations whose results are never read);
- the output of tick t is written at ``clip(t - (S - 1), 0, M - 1)``;
- the head and the loss run on every stage, masked to the last one before
  the sum over the pipe axis, then averaged over the data axis (each data
  shard's loss is the mean over its rows).

The forward is plain torch and autograd differentiates through the ring
shifts, whose backward is the reverse shift: every stage's graph is the same
sequence of operations (the stage conditions are tensors, as JAX's
``jnp.where``), so every rank runs the backward's shifts in the same order.
The embeddings, the final LayerNorm and the tied head are replicated; their
gradients are summed over both axes, the blocks' over the data axis, as
JAX's ``shard_map`` transpose sums the gradients of replicated inputs.
``torch.distributed.pipelining`` is not used: its microbatch loss
convention is not JAX's.

Numerical contract (tests/test_torch_pipeline.py): the loss and every
parameter gradient match the plain single-device step to fp32 tolerance.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ai_music_generation_tpu_torch.models.gpt import (
    Block,
    GPTConfig,
    _layer_norm,
    cross_entropy_ignore_index,
)
from ai_music_generation_tpu_torch.parallel.collectives import ring_shift
from ai_music_generation_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

BLOCKS = "transformer.h."


def make_pipe_mesh(n_data: int = 1, n_pipe: int = 1,
                   device: str = "cuda") -> DeviceMesh:
    """A (data, pipe) ``DeviceMesh`` over the process group's ranks, rank r
    at (r // n_pipe, r % n_pipe): ``pipe`` is the minor axis, so the
    stages of a pipeline are neighbouring ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: start under torchrun and call "
            "parallel.distributed.initialize_distributed() first")
    world = dist.get_world_size()
    if n_data * n_pipe != world:
        raise ValueError(f"mesh {n_data}x{n_pipe} != {world} processes")
    return init_device_mesh(torch.device(device).type, (n_data, n_pipe),
                            mesh_dim_names=(DATA_AXIS, PIPE_AXIS))


# -- staged parameter layout -------------------------------------------------


def stack_block_params(state: dict, n_layer: int) -> tuple[dict, dict]:
    """Split a GPT ``state_dict`` into (stacked, shared): ``stacked[name]``
    is the blocks' tensor ``name`` stacked on a new leading layer dim of
    ``n_layer``; ``shared`` holds every other entry (wte, wpe, ln_f and the
    tied ``lm_head.weight``)."""
    first = BLOCKS + "0."
    names = [k[len(first):] for k in state if k.startswith(first)]
    stacked = {name: torch.stack([state[f"{BLOCKS}{i}.{name}"]
                                  for i in range(n_layer)])
               for name in names}
    shared = {k: v for k, v in state.items() if not k.startswith(BLOCKS)}
    return stacked, shared


def unstack_block_params(stacked: dict, shared: dict) -> dict:
    """Inverse of :func:`stack_block_params`: the plain ``state_dict``."""
    out = dict(shared)
    n_layer = next(iter(stacked.values())).shape[0]
    for i in range(n_layer):
        for name, t in stacked.items():
            out[f"{BLOCKS}{i}.{name}"] = t[i]
    return out


class PipelineGPT(nn.Module):
    """One stage of a GPT on a (data, pipe) mesh: the blocks ``stage *
    L_s .. (stage + 1) * L_s - 1`` (``L_s = n_layer / n_stages``, named
    ``transformer.h.0 ..`` here) and the replicated ``wte``, ``wpe`` and
    ``ln_f``, with JAX's guards (its :110-118). Load it from a plain
    ``state_dict`` with :meth:`load_plain`; :meth:`plain` gathers tensors
    of its layout (parameters, gradients) back to the plain one. ``device``
    None creates the parameters on the card, and raises without one."""

    def __init__(self, config: GPTConfig, mesh: DeviceMesh, device=None):
        super().__init__()
        S = mesh.size(mesh.mesh_dim_names.index(PIPE_AXIS))
        if config.n_layer % S:
            raise ValueError(f"n_layer {config.n_layer} not divisible by {S} "
                             "pipeline stages")
        if config.dropout != 0.0:
            raise ValueError("pipeline training path requires dropout=0")
        if config.n_expert != 0:
            raise ValueError(
                "MoE blocks return a third (aux-loss) element the GPipe "
                "schedule does not thread; use the dp/tp/fsdp paths for MoE "
                "models")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PipelineGPT creates its parameters on the CUDA device by "
                    'default and none is available; pass device="cpu"')
            device = torch.device("cuda")
        self.config, self.mesh = config, mesh
        self.n_stages, self.stage = S, mesh.get_local_rank(PIPE_AXIS)
        self.n_data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.pipe_group = mesh.get_group(PIPE_AXIS)
        self.data_group = mesh.get_group(DATA_AXIS)
        C, dt = config.n_embd, config.param_dtype
        with torch.device(device):
            self.transformer = nn.ModuleDict(dict(
                wte=nn.Embedding(config.vocab_size, C, dtype=dt),
                wpe=nn.Embedding(config.block_size, C, dtype=dt),
                h=nn.ModuleList(Block(config)
                                for _ in range(config.n_layer // S)),
                ln_f=nn.LayerNorm(C, eps=1e-5, bias=config.bias, dtype=dt),
            ))

    def _layer0(self) -> int:
        return self.stage * len(self.transformer.h)

    @torch.no_grad()
    def load_plain(self, state: dict) -> None:
        """This stage's part of a plain GPT ``state_dict``."""
        stacked, shared = stack_block_params(state, self.config.n_layer)
        local = {k: v for k, v in shared.items() if k.startswith("transformer.")}
        n = len(self.transformer.h)
        for name, t in stacked.items():
            for j in range(n):
                local[f"{BLOCKS}{j}.{name}"] = t[self._layer0() + j]
        self.load_state_dict(local)

    @torch.no_grad()
    def plain(self, tensors: dict) -> dict:
        """``tensors`` named as this module's parameters (the parameters,
        or their gradients) in the plain GPT layout: every stage's blocks
        gathered over the pipe axis, ``lm_head.weight`` the tied ``wte``. A
        collective of the pipe group."""
        n = len(self.transformer.h)
        first = BLOCKS + "0."
        shared = {k: v for k, v in tensors.items() if not k.startswith(BLOCKS)}
        shared["lm_head.weight"] = shared["transformer.wte.weight"]
        stacked = {}
        for key in tensors:
            if not key.startswith(first):
                continue
            name = key[len(first):]
            local = torch.stack([tensors[f"{BLOCKS}{j}.{name}"]
                                 for j in range(n)]).contiguous()
            whole = local.new_empty((self.n_stages * n, *local.shape[1:]))
            dist.all_gather_into_tensor(whole, local, group=self.pipe_group)
            stacked[name] = whole
        return unstack_block_params(stacked, shared)

    def local_loss(self, idx: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """The schedule (module docstring) over this data shard's [M, mb, T]
        microbatches: the loss masked to the last stage and divided by the
        data-axis size, so its sum over the mesh is JAX's loss (the value to
        call ``backward`` on)."""
        cfg, tr = self.config, self.transformer
        S, dt, dev = self.n_stages, cfg.dtype, idx.device
        M, T = idx.shape[0], idx.shape[-1]
        wte = tr.wte.weight.to(dt)
        pos = torch.arange(T, device=dev)
        emb = F.embedding(idx, wte) + F.embedding(pos, tr.wpe.weight.to(dt))
        first = torch.tensor(self.stage == 0, device=dev)
        last = torch.tensor(self.stage == S - 1, device=dev)
        act = torch.zeros_like(emb[0])
        outs = [None] * M
        for t in range(M + S - 1):
            x = torch.where(first, emb[min(t, M - 1)], act)
            for block in tr.h:
                x = block(x)
            # the write index is monotone: fill ticks write slot 0, then the
            # true microbatch 0 overwrites it at t = S - 1, then 1, 2, ...
            outs[min(max(t - (S - 1), 0), M - 1)] = x
            act = ring_shift(x, self.pipe_group)
        x = _layer_norm(torch.stack(outs), tr.ln_f)
        loss = cross_entropy_ignore_index(F.linear(x, wte), targets)
        return torch.where(last, loss, 0.0) / self.n_data

    def sync_grads(self) -> None:
        """The gradients summed as JAX's transpose sums them: the blocks'
        over the data axis, the replicated rest over both axes."""
        for name, p in self.named_parameters():
            if p.grad is None:
                continue
            if not name.startswith(BLOCKS):
                dist.all_reduce(p.grad, group=self.pipe_group)
            dist.all_reduce(p.grad, group=self.data_group)


def make_pipeline_loss(model: PipelineGPT, n_micro: int) -> Callable:
    """``loss(x, y) -> (share, loss)``: x, y the GLOBAL [B, T] batch, split
    into ``n_micro`` microbatches of which this data rank runs its rows.
    ``share`` is :meth:`PipelineGPT.local_loss` (call ``backward`` on it,
    then :meth:`PipelineGPT.sync_grads`), ``loss`` JAX's loss (detached,
    equal on every rank)."""

    def loss_fn(x: torch.Tensor, y: torch.Tensor):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        mb = B // n_micro
        if mb % model.n_data:
            raise ValueError(f"microbatch of {mb} rows does not split over "
                             f"{model.n_data} data ranks")
        rows = mb // model.n_data
        mine = slice(model.data_rank * rows, (model.data_rank + 1) * rows)
        xm = x.reshape(n_micro, mb, -1)[:, mine]
        ym = y.reshape(n_micro, mb, -1)[:, mine]
        share = model.local_loss(xm, ym)
        loss = share.detach().clone()
        dist.all_reduce(loss, group=model.pipe_group)
        dist.all_reduce(loss, group=model.data_group)
        return share, loss

    return loss_fn


def make_pipeline_train_step(model: PipelineGPT,
                             optimizer: torch.optim.Optimizer,
                             mesh: DeviceMesh, n_micro: int,
                             schedule: Optional[Callable[[int], float]] = None
                             ) -> Callable:
    """Build ``step(x, y) -> metrics`` over the global [B, T] batch: the
    pipelined loss, its backward, the gradients summed
    (:meth:`PipelineGPT.sync_grads`) and ``optimizer`` (over ``model``'s
    parameters, e.g. ``train/optimizer.py::optax_adamw``: its moments are
    staged as the parameters are) updating the staged tree. metrics:
    ``loss`` and, with ``schedule``, ``lr`` (``schedule`` of the step count,
    set as every group's lr)."""
    if mesh is not model.mesh:
        raise ValueError("the step's mesh is not the model's")
    loss_fn = make_pipeline_loss(model, n_micro)
    count = [0]

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.train()
        share, loss = loss_fn(x, y)
        share.backward()
        model.sync_grads()
        metrics = {"loss": loss}
        if schedule is not None:
            metrics["lr"] = schedule(count[0])
            for group in optimizer.param_groups:
                group["lr"] = metrics["lr"]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        count[0] += 1
        return metrics

    return step
