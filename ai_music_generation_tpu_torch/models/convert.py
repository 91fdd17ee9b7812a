"""Weights for the port's GPT and TunesFormer: converted from the JAX
package's params, or initialised with the JAX package's scheme; and the JAX
optimizer states converted to the port's AdamW states (GPT and TunesFormer).

The state dict uses nanoGPT's names and torch layouts, the same keys and
values as the JAX package's ``models/nanogpt_ckpt.py::
nanogpt_state_from_params`` (that module imports jax, so the mapping is
repeated here in numpy).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer, TunesFormerConfig,
)


def state_dict_from_jax(params: Mapping[str, Any],
                        config: GPTConfig) -> dict[str, torch.Tensor]:
    """The JAX GPT's nested param dict (numpy arrays, e.g. from
    ``jax.device_get(params)``) -> the port's ``state_dict`` (fp32). Flax
    ``Dense`` kernels are [in, out] and torch ``Linear`` weights [out, in],
    so kernels are transposed. ``lm_head.weight`` is the same tensor as
    ``transformer.wte.weight`` (weight tying)."""
    p = params["params"] if "params" in params else params

    wte = _t(p["wte"]["embedding"])
    out = {"transformer.wte.weight": wte}
    out.update(_core_from_jax(p, config, "transformer."))
    out["lm_head.weight"] = wte
    return out


def _t(x, transpose=False) -> torch.Tensor:
    x = np.asarray(x, np.float32)
    return torch.from_numpy(np.array(x.T if transpose else x, order="C"))


def _core_from_jax(p: Mapping[str, Any], config: GPTConfig,
                   prefix: str) -> dict[str, torch.Tensor]:
    """``wpe``, the blocks and ``ln_f`` of one JAX GPT stack (a GPT's
    params or a TunesFormer core's) under ``prefix``."""
    out = {prefix + "wpe.weight": _t(p["wpe"]["embedding"])}
    for i in range(config.n_layer):
        blk, h = p[f"h_{i}"], f"{prefix}h.{i}."
        for mod, names in (("ln_1", None), ("attn", ("c_attn", "c_proj")),
                           ("ln_2", None), ("mlp", ("c_fc", "c_proj"))):
            if names is None:  # LayerNorm
                out[h + mod + ".weight"] = _t(blk[mod]["scale"])
                if config.bias:
                    out[h + mod + ".bias"] = _t(blk[mod]["bias"])
                continue
            for name in names:
                out[h + f"{mod}.{name}.weight"] = _t(
                    blk[mod][name]["kernel"], transpose=True)
                if config.bias:
                    out[h + f"{mod}.{name}.bias"] = _t(blk[mod][name]["bias"])
    out[prefix + "ln_f.weight"] = _t(p["ln_f"]["scale"])
    if config.bias:
        out[prefix + "ln_f.bias"] = _t(p["ln_f"]["bias"])
    return out


def tunesformer_state_dict_from_jax(params: Mapping[str, Any],
                                    config: TunesFormerConfig
                                    ) -> dict[str, torch.Tensor]:
    """The JAX TunesFormer's nested param dict (numpy arrays) -> the port's
    ``state_dict`` (fp32): the patch embedding's kernel is already the
    gather table, the cores map as a GPT's stack does (``core`` with
    ``share_weights``)."""
    p = params["params"] if "params" in params else params
    out = {"patch_embedding.weight": _t(p["patch_embedding"]["kernel"]),
           "patch_embedding.bias": _t(p["patch_embedding"]["bias"]),
           "char_wte.weight": _t(p["char_wte"]["embedding"])}
    if config.share_weights:
        out.update(_core_from_jax(p["core"], config.patch_core_config(),
                                  "core."))
    else:
        out.update(_core_from_jax(p["patch_core"],
                                  config.patch_core_config(), "patch_core."))
        out.update(_core_from_jax(p["char_core"], config.char_core_config(),
                                  "char_core."))
    return out


@torch.no_grad()
def init_weights(model: GPT, generator: torch.Generator) -> GPT:
    """The JAX package's init in place: every Linear and Embedding weight
    N(0, 0.02), the residual projections (both ``c_proj``) N(0,
    0.02/sqrt(2*n_layer)), biases 0, LayerNorm scales 1. ``generator`` must
    be on the model's device."""
    _init_modules(model, model.config.n_layer, generator)
    return model


def _init_modules(root: nn.Module, n_layer: int,
                  generator: torch.Generator) -> None:
    proj_std = 0.02 / math.sqrt(2 * n_layer)
    for name, module in root.named_modules():
        if isinstance(module, nn.Linear):
            if name == "lm_head":
                continue  # tied to transformer.wte, initialised there
            std = proj_std if name.endswith("c_proj") else 0.02
            module.weight.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            if module.bias is not None:
                module.bias.zero_()


@torch.no_grad()
def init_tunesformer_weights(model: TunesFormer,
                             generator: torch.Generator) -> TunesFormer:
    """The JAX TunesFormer's init in place: each core as :func:`
    init_weights` initialises a GPT (its residual projections at
    0.02/sqrt(2*n_layer) of that core), the patch embedding's table and
    ``char_wte`` N(0, 0.02), its bias 0. ``generator`` must be on the
    model's device."""
    model.patch_embedding.weight.normal_(0.0, 0.02, generator=generator)
    model.patch_embedding.bias.zero_()
    model.char_wte.weight.normal_(0.0, 0.02, generator=generator)
    for core in dict.fromkeys((model.patch_core, model.char_core)):
        _init_modules(core, core.config.n_layer, generator)
    return model


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(opt_state, model: GPT,
                             optimizer: torch.optim.Optimizer) -> dict:
    """The JAX trainer's optax state (``train/optimizer.py``'s chain of
    clip, ``scale_by_adam``, masked decay and the schedule; numpy leaves,
    e.g. from ``jax.device_get``) -> a ``state_dict`` for ``optimizer``
    (the port's AdamW over ``model``, ``train/optimizer.py``): each
    parameter's ``exp_avg`` and ``exp_avg_sq`` are the adam state's ``mu``
    and ``nu`` in the port's layout (kernels transposed, as
    :func:`state_dict_from_jax`), ``step`` its ``count``."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")
    mu = state_dict_from_jax(adam.mu, model.config)
    nu = state_dict_from_jax(adam.nu, model.config)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    name = {id(p): n for n, p in model.named_parameters()}
    state, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = name[id(p)]
            state[i] = {"step": step.clone(), "exp_avg": mu[n].clone(),
                        "exp_avg_sq": nu[n].clone()}
            i += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def tunes_optimizer_state_from_jax(opt_state, model: TunesFormer,
                                   optimizer: torch.optim.Optimizer) -> dict:
    """An ``optax.adamw`` state (the JAX TunesFormer CLI's: ``count``,
    ``mu``, ``nu`` of its ``ScaleByAdamState``; numpy leaves) -> a
    ``state_dict`` for ``optimizer`` (``train/optimizer.py::optax_adamw``
    over ``model``): ``exp_avg`` and ``exp_avg_sq`` are ``mu`` and ``nu``
    in the port's layout (:func:`tunesformer_state_dict_from_jax`),
    ``step`` the count of applied updates (optax's schedule count equals it:
    both advance together and the NaN guard holds both)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")
    mu = tunesformer_state_dict_from_jax(adam.mu, model.config)
    nu = tunesformer_state_dict_from_jax(adam.nu, model.config)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    name = {id(p): n for n, p in model.named_parameters()}
    state = {i: {"step": step.clone(), "exp_avg": mu[name[id(p)]].clone(),
                 "exp_avg_sq": nu[name[id(p)]].clone()}
             for i, p in enumerate(p for g in optimizer.param_groups
                                   for p in g["params"])}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
