"""The port's mesh rules and mesh-free pieces (ai_music_generation_tpu_torch/
parallel/, ``BinDataset.sharded_sample``, the dropout blocks) against the
JAX package, in this process (no process group).

- ``placements_for`` equals JAX ``shardings_for_tree`` leaf by leaf, for a
  dense, a GQA and an MoE GPT and a TunesFormer, with ``fsdp`` on and off,
  on the meshes (8, 1), (4, 2) and (2, 4) of the 8 virtual CPU devices
  (tests/conftest.py): each JAX leaf's PartitionSpec, padded to its rank,
  against the port parameter's placements stated over the JAX layout (a
  flax ``Dense`` kernel is the torch weight transposed, as
  ``models/convert.py`` converts it; the TunesFormer patch embedding keeps
  the JAX layout). Exact.
- ``sharded_sample`` gives each data rank JAX's addressable rows of the
  same global batch. Exact.
- a dropout mask's block at global coordinates is the single-card site's
  slice. Exact.

Tiny models: 2 layers, 4 heads, width 64, vocab 64, block 16 (GQA: 2 K/V
heads; MoE: 4 experts; TunesFormer: 2+2 layers, 32 wide, 2 heads).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ai_music_generation_tpu.data.memmap import BinDataset as JaxBinDataset
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormer as JaxTunesFormer,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormerConfig as JaxTunesConfig,
)
from ai_music_generation_tpu.parallel import mesh as jax_mesh
from ai_music_generation_tpu_torch.data.memmap import BinDataset, write_bin
from ai_music_generation_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    dropout_keep,
)
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
)
from ai_music_generation_tpu_torch.parallel import distributed, mesh
from ai_music_generation_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

GPT_ARCH = dict(block_size=16, vocab_size=64, n_layer=2, n_head=4, n_embd=64)
TUNES_ARCH = dict(patch_length=8, patch_size=16, patch_layers=2,
                  char_layers=2, n_embd=32, n_head=2)
MODELS = {"dense": {}, "gqa": dict(n_kv_head=2), "moe": dict(n_expert=4),
          "tunes": None}
MESHES = [(8, 1), (4, 2), (2, 4)]


@functools.lru_cache(maxsize=None)
def _jax_params(kind):
    """The JAX parameter tree's shapes (``jax.eval_shape`` of the init:
    the rules read shapes only)."""
    if kind == "tunes":
        model = JaxTunesFormer(JaxTunesConfig(**TUNES_ARCH, dropout=0.0,
                                              dtype=jnp.float32))
        dummy = jnp.zeros((1, 8, 16), jnp.int32)
    else:
        model = JaxGPT(JaxGPTConfig(**GPT_ARCH, **MODELS[kind],
                                    dtype=jnp.float32))
        dummy = jnp.zeros((1, 16), jnp.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), dummy)


def _port_shapes(kind):
    if kind == "tunes":
        model = TunesFormer(TunesFormerConfig(**TUNES_ARCH), device="meta")
    else:
        model = GPT(GPTConfig(**GPT_ARCH, **MODELS[kind]), device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _port_name(path, kind):
    """The port parameter of a JAX leaf path (``params/h_0/attn/...``) and
    whether it is the leaf transposed (a Dense kernel but the patch
    embedding's, as models/convert.py converts them)."""
    parts = path.split("/")[1:]
    transposed = parts[-1] == "kernel" and parts[-2] != "patch_embedding"
    parts[-1] = {"kernel": "weight", "scale": "weight",
                 "embedding": "weight"}.get(parts[-1], parts[-1])
    name = re.sub(r"h_(\d+)", r"h.\1", ".".join(parts))
    return (name if kind == "tunes" else "transformer." + name), transposed


def _spec_of(placements, ndim, transposed):
    """The placements as a JAX spec over the JAX layout."""
    spec = [None] * ndim
    for axis, placement in zip(mesh.AXES, placements):
        if placement.is_shard():
            d = placement.dim
            spec[ndim - 1 - d if transposed else d] = axis
    return tuple(spec)


CASES = [(kind, fsdp, shape) for kind in MODELS for fsdp in (False, True)
         for shape in MESHES]


@pytest.mark.parametrize(
    "kind,fsdp,shape", CASES,
    ids=[f"{k}-{'fsdp' if f else 'tp'}-{d}x{m}" for k, f, (d, m) in CASES])
def test_placements_equal_jax_rules_leaf_by_leaf(kind, fsdp, shape):
    n_data, n_model = shape
    params = _jax_params(kind)
    shardings = jax_mesh.shardings_for_tree(
        jax_mesh.make_mesh(n_data, n_model), params, fsdp=fsdp)
    shapes = _port_shapes(kind)
    got = mesh.placements_for_tree(shapes, n_data, n_model, fsdp)
    seen = set()
    for path, sharding in jax.tree_util.tree_leaves_with_path(shardings):
        leaf_path = jax_mesh._path_str(path)
        name, transposed = _port_name(leaf_path, kind)
        assert name in shapes, leaf_path
        ndim = len(shapes[name])
        want = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
        assert _spec_of(got[name], ndim, transposed) == want, (name, want)
        seen.add(name)
    assert seen == set(shapes)  # every port parameter is a JAX leaf
    if kind != "tunes":  # the tied head follows wte
        assert mesh.placements_for("lm_head.weight", shapes[
            "transformer.wte.weight"], n_data, n_model, fsdp) == got[
            "transformer.wte.weight"]


def test_moe_experts_split_over_the_model_axis():
    """Expert parallelism's rule: each model rank holds E / n_model whole
    experts (JAX parallel/mesh.py:67-75); the router stays replicated."""
    shapes = _port_shapes("moe")
    got = mesh.placements_for_tree(shapes, 2, 2)
    for leaf in ("w_fc", "w_proj", "b_fc", "b_proj"):
        assert got[f"transformer.h.0.moe.{leaf}"][1] == mesh.Shard(0)
    assert got["transformer.h.0.moe.router.weight"] == (mesh.Replicate(),) * 2


def test_fsdp_placement_keeps_a_dim_on_a_data_axis_of_one():
    """At n_data 1 JAX shards nothing over data; the FSDP placement still
    names the dim the rule would (a Shard over one rank is whole)."""
    assert mesh.placements_for("transformer.h.0.attn.c_attn.weight",
                               (192, 64), 1, 1, fsdp=True)[0] == (
        mesh.Replicate())
    assert mesh.fsdp_placement("transformer.h.0.attn.c_attn.weight",
                               (192, 64), 1, 1) == mesh.Shard(1)
    assert mesh.fsdp_placement("transformer.ln_f.weight", (64,), 1, 1) == (
        mesh.Replicate())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("bin")
    path = str(root / "train.bin")
    write_bin(np.random.default_rng(0).integers(0, 64, 5000), path)
    return path


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("accum", [True, False], ids=["accum", "eval"])
def test_sharded_sample_rows_are_jax_addressable_rows(dataset, shape, accum):
    """Each data rank's ``sharded_sample`` rows are the rows JAX's
    ``sharded_sample`` places on the devices of that data coordinate."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n_data, n_model = shape
    jmesh = jax_mesh.make_mesh(n_data, n_model)
    batch_shape = (2, 8) if accum else (8,)
    spec = P(None, jax_mesh.DATA_AXIS) if accum else P(jax_mesh.DATA_AXIS)
    jx, jy = JaxBinDataset(dataset).sharded_sample(
        3, 5, batch_shape, 16, NamedSharding(jmesh, spec))
    ds = BinDataset(dataset)
    coords = {dev.id: i // n_model
              for i, dev in enumerate(jmesh.devices.reshape(-1))}
    for xs, ys in zip(jx.addressable_shards, jy.addressable_shards):
        x, y = ds.sharded_sample(3, 5, batch_shape, 16,
                                 (coords[xs.device.id], n_data))
        np.testing.assert_array_equal(np.asarray(xs.data), x)
        np.testing.assert_array_equal(np.asarray(ys.data), y)
    assert (np.concatenate([ds.sharded_sample(3, 5, batch_shape, 16,
                                              (d, n_data))[0]
                            for d in range(n_data)], axis=-2)
            == ds.sample(3, 5, batch_shape, 16)[0]).all()


BLOCKS = [((2, 3, 4, 4), (1, 1, 0, 0), (6, 6, 4, 4)),  # attention probs
          ((3, 5, 8), (6, 0, 0), (12, 5, 8)),  # a data rank's rows
          ((4, 4), (0, 0), (4, 4))]  # the whole site


@pytest.mark.parametrize("shape,start,full", BLOCKS,
                         ids=["probs", "rows", "whole"])
def test_dropout_block_is_the_sites_slice(shape, start, full):
    whole = dropout_keep(full, 0.3, 12345, 1, 1)
    block = dropout_keep(shape, 0.3, 12345, 1, 1, start=start, full=full)
    index = tuple(slice(a, a + n) for a, n in zip(start, shape))
    assert torch.equal(block, whole[index])


def test_initialize_distributed_is_a_noop_without_torchrun(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    info = distributed.initialize_distributed("cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized() and distributed.is_main_process()


def test_a_mesh_needs_a_process_group(tmp_path):
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh(1, 1, "cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(dict(n_model=2, device="cpu", out_dir=str(tmp_path)))


def test_a_cuda_caller_never_gets_gloo(monkeypatch):
    """Without a card a CUDA caller raises before any group starts (no
    fallback to gloo or the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        distributed.initialize_distributed(
            "cuda", rank=0, world_size=1, master_addr="localhost",
            master_port=1)
    assert not dist.is_initialized()
