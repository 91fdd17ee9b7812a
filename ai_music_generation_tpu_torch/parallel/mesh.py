"""Device mesh and sharding rules: the port of
``ai_music_generation_tpu/parallel/mesh.py``.

Axes, as in JAX:

- ``data``  — batch (data parallel; the reference's only strategy, DDP);
- ``model`` — tensor parallel over attention heads and the MLP hidden
  dim, expert parallel over the MoE experts.

The rules say which parameter is split on which axis. They are the JAX
package's (``_GPT_PARAM_RULES``, its ``shardings_for_tree``), matched on
the port's parameter names and stated over the JAX layout of each tensor
(a torch ``Linear.weight`` is the flax kernel transposed, so the kernel's
``P(None, model)`` is ``Shard(0)`` on the weight), with JAX's two extra
rules:

- a dim that its axis cannot divide evenly is replicated (an odd vocab from
  a dataset's meta.pkl on a 2-way model axis);
- with ``fsdp``, every >= 2-D tensor is also sharded over ``data`` on the
  largest evenly divisible dim its model rule leaves free (ZeRO-3); 1-D
  tensors stay replicated.

:func:`placements_for` states the result as DTensor placements, one per
mesh dim, and is a function of the axis sizes alone, not of a live
``DeviceMesh``. ``parallel/sharding.py`` applies it: tensor and expert
parallelism by slicing each parameter to its model-axis part, the data axis
by FSDP2 (``fully_shard``) or DDP. Optimizer moments follow their
parameter's placements.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
# the minor axes of the sequence-parallel and pipeline meshes
# (parallel/sequence.py, parallel/pipeline.py)
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cuda") -> DeviceMesh:
    """A 2-D (data, model) ``DeviceMesh`` over the process group's ranks,
    rank r at (r // n_model, r % n_model). With the defaults every rank
    goes to the data axis, the reference's pure-DP layout."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: start under torchrun and call "
            "parallel.distributed.initialize_distributed() first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=AXES)


# (the port's parameter name, the JAX rule's PartitionSpec over the JAX
# layout, whether the port's tensor is the JAX leaf transposed). Megatron
# layout: QKV and MLP-in column parallel, attention-out and MLP-out row
# parallel, the embeddings on vocab; MoE experts on their leading dim
# (expert parallelism; the fp32 router replicated); the TunesFormer patch
# embedding [patch_size * 128, n_embd] on n_embd, as the c_fc output
_GPT_PARAM_RULES: list[tuple[str, tuple, bool]] = [
    (r".*attn\.c_attn\.weight", (None, MODEL_AXIS), True),
    (r".*attn\.c_attn\.bias", (MODEL_AXIS,), False),
    (r".*attn\.c_proj\.weight", (MODEL_AXIS, None), True),
    (r".*mlp\.c_fc\.weight", (None, MODEL_AXIS), True),
    (r".*mlp\.c_fc\.bias", (MODEL_AXIS,), False),
    (r".*mlp\.c_proj\.weight", (MODEL_AXIS, None), True),
    (r".*wte\.weight", (MODEL_AXIS, None), False),
    (r"lm_head\.weight", (MODEL_AXIS, None), False),  # tied to wte
    (r".*wpe\.weight", (None, None), False),
    (r".*moe\.w_fc", (MODEL_AXIS, None, None), False),
    (r".*moe\.w_proj", (MODEL_AXIS, None, None), False),
    (r".*moe\.b_fc", (MODEL_AXIS, None), False),
    (r".*moe\.b_proj", (MODEL_AXIS, None), False),
    (r".*moe\.router\.weight", (), True),
    (r".*patch_embedding\.weight", (None, MODEL_AXIS), False),
    (r".*patch_embedding\.bias", (MODEL_AXIS,), False),
    (r".*", (), False),  # layernorms, remaining biases: replicated
]


def spec_for_param(name: str) -> tuple[tuple, bool]:
    """(the JAX PartitionSpec of ``name`` as a tuple over the JAX layout,
    whether the port's tensor is that layout transposed)."""
    for pattern, spec, transposed in _GPT_PARAM_RULES:
        if re.fullmatch(pattern, name):
            return spec, transposed
    return (), False


def _jax_spec(name: str, shape: Sequence[int], n_data: int, n_model: int,
              fsdp: bool, data_over_one: bool = False) -> tuple[list, bool]:
    """(the JAX rule's spec over the JAX layout, one axis name or None a
    dim, after its two extra rules; transposed). ``data_over_one`` keeps
    the FSDP dim on a data axis of 1 (where JAX shards nothing)."""
    spec, transposed = spec_for_param(name)
    ndim = len(shape)
    jshape = tuple(reversed(shape)) if transposed else tuple(shape)
    spec = tuple(spec[:ndim]) + (None,) * (ndim - len(spec))
    size = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    fixed = [None if axis is not None and jshape[i] % size[axis] else axis
             for i, axis in enumerate(spec)]
    if fsdp and ndim >= 2 and (n_data > 1 or data_over_one):
        free = [i for i, axis in enumerate(fixed)
                if axis is None and jshape[i] % n_data == 0]
        if free:
            fixed[max(free, key=lambda i: jshape[i])] = DATA_AXIS
    return fixed, transposed


def _placements(fixed: list, transposed: bool) -> tuple[Placement, ...]:
    ndim = len(fixed)
    out = []
    for axis in AXES:
        dims = [i for i, a in enumerate(fixed) if a == axis]
        out.append(Replicate() if not dims else
                   Shard(ndim - 1 - dims[0] if transposed else dims[0]))
    return tuple(out)


def placements_for(name: str, shape: Sequence[int], n_data: int,
                   n_model: int, fsdp: bool = False
                   ) -> tuple[Placement, Placement]:
    """The (data, model) DTensor placements of the port's parameter
    ``name`` of full ``shape`` on an ``n_data`` x ``n_model`` mesh: JAX's
    ``shardings_for_tree`` leaf rule (module docstring), with the dims
    counted in the port's layout."""
    return _placements(*_jax_spec(name, shape, n_data, n_model, fsdp))


def fsdp_placement(name: str, shape: Sequence[int], n_data: int,
                   n_model: int) -> Placement:
    """The data-axis placement that FSDP gives ``name``: the rule's, but
    kept on a data axis of 1, so a one-card run goes through the same
    machinery (there ``Shard`` over one rank is the whole tensor)."""
    return _placements(*_jax_spec(name, shape, n_data, n_model, True,
                                  data_over_one=True))[0]


def placements_for_tree(shapes: Mapping[str, Sequence[int]], n_data: int,
                        n_model: int, fsdp: bool = False
                        ) -> dict[str, tuple[Placement, Placement]]:
    """:func:`placements_for` of every named shape (the counterpart of
    JAX's ``shardings_for_tree``)."""
    return {name: placements_for(name, shape, n_data, n_model, fsdp)
            for name, shape in shapes.items()}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this process sits on a ``DeviceMesh`` whose dims are named
    from ``data``, ``model`` and ``seq``. The modules that a mesh splits
    (``models/gpt.py``, ``models/moe.py``, ``models/tunesformer.py``) hold
    one as ``layout`` (None: one card) and read the axis sizes, this rank's
    coordinates and the axis groups from it; an axis the mesh lacks has
    size 1, coordinate 0 and no group. Each value is looked up once (a
    mesh does not change, and every cached decode step reads them)."""

    mesh: DeviceMesh

    def _size(self, axis: str) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index(axis)) if axis in names else 1

    def _rank(self, axis: str) -> int:
        if axis not in self.mesh.mesh_dim_names:
            return 0
        return self.mesh.get_local_rank(axis)

    def _group(self, axis: str):
        if axis not in self.mesh.mesh_dim_names:
            return None
        return self.mesh.get_group(axis)

    @functools.cached_property
    def n_data(self) -> int:
        return self._size(DATA_AXIS)

    @functools.cached_property
    def n_model(self) -> int:
        return self._size(MODEL_AXIS)

    @functools.cached_property
    def n_seq(self) -> int:
        return self._size(SEQ_AXIS)

    @functools.cached_property
    def data_rank(self) -> int:
        return self._rank(DATA_AXIS)

    @functools.cached_property
    def model_rank(self) -> int:
        return self._rank(MODEL_AXIS)

    @functools.cached_property
    def seq_rank(self) -> int:
        return self._rank(SEQ_AXIS)

    @functools.cached_property
    def data_group(self):
        return self._group(DATA_AXIS)

    @functools.cached_property
    def model_group(self):
        return self._group(MODEL_AXIS)

    @functools.cached_property
    def seq_group(self):
        return self._group(SEQ_AXIS)
