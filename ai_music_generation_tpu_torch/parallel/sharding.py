"""The mesh rules applied to a model: the port of what JAX does with
``shardings_for_tree`` and ``jax.device_put`` (``train/trainer.py``,
``train/tunes_step.py``), in PyTorch's terms.

- **Model axis** (tensor and expert parallelism): each parameter whose
  ``placements_for`` model placement is ``Shard(d)`` becomes this rank's
  chunk of dim d, and every module whose forward runs a mesh part
  (``models/gpt.py``, ``models/moe.py``, ``models/tunesformer.py``) gets
  the :class:`~.mesh.Layout` as ``layout`` and, as ``split``, the names of
  its parameters that are split; the forward reads which of its parts to
  run from ``split`` alone and runs them with the collectives of
  ``parallel/collectives.py``. Parameters stay plain local tensors, so the
  IEEE router (``models/moe.py::_IEEELinear``) and every other op run on
  local tensors.
- **Data axis**: FSDP2 (``fully_shard``, one unit per transformer block
  and the root) on the mesh's data dim with ``shard_placement_fn`` giving
  each tensor the dim of the JAX FSDP rule (``fsdp_placement``), or, without
  ``fsdp``, DDP over the data group. FSDP2 has no per-parameter replicate:
  the tensors that JAX leaves replicated over data (1-D ones, and those with
  no evenly divisible free dim) are sharded on dim 0 (FSDP2's default),
  which changes where they live and not what is computed.

:class:`MeshPlan` keeps the placements and gives the train step and the
checkpoints what they need: the gradient-sync switch for the micro-steps,
the process group each gradient is split over (for the global norm), the
data-axis mean of a metric, and the whole (topology-free) state of a model
and its optimizer, gathered and scattered.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from ai_music_generation_tpu_torch.models.gpt import Block
from ai_music_generation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Layout,
    fsdp_placement,
    placements_for,
)


def _aliases(model: nn.Module) -> dict[str, str]:
    """{second name: canonical name} of every parameter registered under
    two names (GPT's ``lm_head.weight`` is ``transformer.wte.weight``)."""
    canonical = {id(p): n for n, p in model.named_parameters()}
    return {name: canonical[id(p)] for name, p in
            model.named_parameters(remove_duplicate=False)
            if canonical[id(p)] != name}


def parallelize(model: nn.Module, layout: Layout, fsdp: bool = False,
                data_parallel: bool = True) -> tuple[nn.Module, "MeshPlan"]:
    """Split ``model`` (whole, the same on every rank) over ``layout``'s
    mesh in place: its model-axis parts, then the data axis (FSDP2 with
    ``fsdp``, else DDP when the axis has more than one rank; neither
    without ``data_parallel``, as the servers run, which keep no
    gradients). Returns (the module to call forward on: the model, or its
    DDP wrapper; the plan)."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    placements = {n: placements_for(n, s, layout.n_data, layout.n_model,
                                    fsdp) for n, s in shapes.items()}
    # the parameters split over the model axis: each becomes this rank's
    # chunk of its Shard dim (the rules split only evenly divisible dims)
    split = {n for n, (_, placement) in placements.items()
             if isinstance(placement, Shard) and layout.n_model > 1}
    aliases = _aliases(model)
    for name in split:
        owner, _, attr = name.rpartition(".")
        p = model.get_parameter(name)
        local = p.detach().chunk(layout.n_model, placements[name][1].dim)[
            layout.model_rank]
        setattr(model.get_submodule(owner), attr, nn.Parameter(
            local.contiguous(), requires_grad=p.requires_grad))
    for alias, name in aliases.items():
        owner, _, attr = alias.rpartition(".")
        setattr(model.get_submodule(owner), attr, model.get_parameter(name))
    # every module whose forward runs a mesh part gets the layout and the
    # names (relative to it) of its parameters that are split
    for prefix, m in model.named_modules():
        if hasattr(type(m), "layout"):
            m.layout = layout
            dot = prefix + "." if prefix else ""
            m.split = frozenset(n for n, _ in m.named_parameters()
                                if dot + n in split)
    module = model
    if fsdp:
        by_id = {id(p): n for n, p in model.named_parameters()}

        def shard_placement(p):
            placement = fsdp_placement(by_id[id(p)], shapes[by_id[id(p)]],
                                       layout.n_data, layout.n_model)
            return placement if isinstance(placement, Shard) else None

        data_mesh = layout.mesh[DATA_AXIS]
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, mesh=data_mesh,
                            shard_placement_fn=shard_placement)
        fully_shard(model, mesh=data_mesh, shard_placement_fn=shard_placement)
    elif layout.n_data > 1 and data_parallel:
        device = next(model.parameters()).device
        module = nn.parallel.DistributedDataParallel(
            model, process_group=layout.data_group,
            device_ids=[device] if device.type == "cuda" else None)
    return module, MeshPlan(layout, placements, split, module, fsdp, aliases)


class MeshPlan:
    """A model's placements on a mesh (:func:`parallelize`)."""

    def __init__(self, layout: Layout, placements: dict, split: set,
                 module: nn.Module, fsdp: bool, aliases: dict):
        self.layout, self.placements = layout, placements
        self.split = split  # the names split over the model axis
        self.module, self.fsdp, self.aliases = module, fsdp, aliases

    # (data, model) placements of a batch: its rows over the data axis
    batch_placements = (Shard(0), Replicate())

    # -- the train step --------------------------------------------------
    def no_sync(self):
        """A context in which backward passes accumulate gradients without
        reducing them over the data axis (the micro-steps before the
        last)."""
        if self.fsdp:
            return _fsdp_no_sync(self.module)
        if isinstance(self.module, nn.parallel.DistributedDataParallel):
            return self.module.no_sync()
        return contextlib.nullcontext()

    def norm_groups(self, model: nn.Module) -> list:
        """The process group each of ``model.parameters()``'s gradients is
        split over (None: whole on this rank), for the global norm."""
        groups = []
        for name, _ in model.named_parameters():
            on_data, on_model = self.fsdp, name in self.split
            groups.append(dist.group.WORLD if on_data and on_model
                          else self.layout.data_group if on_data
                          else self.layout.model_group if on_model else None)
        return groups

    def data_mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a metric over the data axis (the same on every
        rank): the global value of a per-rank share."""
        if self.layout.n_data == 1:
            return value
        value = value.detach().clone()
        dist.all_reduce(value, group=self.layout.data_group)
        return value / self.layout.n_data

    # -- whole tensors ----------------------------------------------------
    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` (or of one of its
        optimizer moments) from this rank's part: gathered over the data
        axis (an FSDP DTensor), then over the model axis."""
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if name in self.split:
            parts = [torch.empty_like(t) for _ in range(self.layout.n_model)]
            dist.all_gather(parts, t.contiguous(),
                            group=self.layout.model_group)
            t = torch.cat(parts, dim=self.placements[name][1].dim)
        return t

    @torch.no_grad()
    def local(self, name: str, full: torch.Tensor,
              like: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full`` of parameter
        ``name``, laid out as ``like`` (the parameter or its moment: a
        local tensor, or an FSDP DTensor on the data axis)."""
        t = full.to(like.device)
        if name in self.split:
            t = t.chunk(self.layout.n_model, dim=self.placements[name][1].dim)[
                self.layout.model_rank]
        if isinstance(like, DTensor):
            return distribute_tensor(t.contiguous(), like.device_mesh,
                                     like.placements, src_data_rank=None)
        return t.contiguous()

    def gather_state(self, model: nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> tuple[dict, Optional[dict]]:
        """(the model's whole ``state_dict``, fp32 on the CPU, a tied
        parameter one tensor under both names; the optimizer's whole
        ``state_dict`` on the CPU, or None). A collective: every rank
        calls it."""
        whole: dict[str, torch.Tensor] = {}
        state = {}
        for key, t in model.state_dict(keep_vars=True).items():
            name = self.aliases.get(key, key)
            if name not in whole:
                whole[name] = self.full(name, t.detach()).to(
                    "cpu", torch.float32, copy=True)
            state[key] = whole[name]
        if optimizer is None:
            return state, None
        order = _param_names(model, optimizer)
        sd = optimizer.state_dict()
        opt_state = {}
        for i, entry in sd["state"].items():
            opt_state[i] = {
                k: (self.full(order[i], v).to("cpu", copy=True)
                    if torch.is_tensor(v) and v.dim() > 0
                    else v.to("cpu", copy=True) if torch.is_tensor(v)
                    else v) for k, v in entry.items()}
        return state, {"state": opt_state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, model: nn.Module,
                             optimizer: torch.optim.Optimizer,
                             whole: dict) -> None:
        """Load a whole optimizer ``state_dict`` (one a single card wrote,
        or :meth:`gather_state`'s) as this rank's parts."""
        order = _param_names(model, optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        local = {}
        for i, entry in whole["state"].items():
            local[i] = {
                k: (self.local(order[i], v, params[i])
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        optimizer.load_state_dict({"state": local,
                                   "param_groups": whole["param_groups"]})


def _param_names(model: nn.Module, optimizer) -> list[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


@contextlib.contextmanager
def _fsdp_no_sync(module):
    module.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        module.set_requires_gradient_sync(True)
