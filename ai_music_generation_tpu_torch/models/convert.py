"""Weights for the port's GPT and TunesFormer: converted from the JAX
package's params, or initialised with the JAX package's scheme; and the JAX
optimizer states converted to the port's AdamW states (GPT and TunesFormer);
the JAX Audiobox predictor's params converted to the port's state dict.

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

from ai_music_generation_tpu_torch.eval.audiobox import AudioboxConfig
from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.moe import MoEMLP
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
    params or a TunesFormer core's) under ``prefix``. An MoE block's
    ``moe`` leaves (JAX moe.py:54-78) keep their layouts (``w_fc`` [E, C,
    4C], ``w_proj`` [E, 4C, C], the biases [E, .]); its router kernel
    [C, E] is transposed to the ``Linear`` weight."""
    out = {prefix + "wpe.weight": _t(p["wpe"]["embedding"])}
    mlp = () if config.n_expert > 0 else (("mlp", ("c_fc", "c_proj")),)
    for i in range(config.n_layer):
        blk, h = p[f"h_{i}"], f"{prefix}h.{i}."
        if config.n_expert > 0:
            out.update({h + "moe." + k: v for k, v in
                        moe_state_dict_from_jax(blk["moe"]).items()})
        for mod, names in (("ln_1", None), ("attn", ("c_attn", "c_proj")),
                           ("ln_2", None)) + mlp:
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


def moe_state_dict_from_jax(p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """One JAX ``MoEMLP``'s params (numpy leaves) -> the port's
    ``MoEMLP`` state dict: the experts and their biases (when present) as
    they are, the router kernel transposed."""
    out = {n: _t(p[n]) for n in ("w_fc", "w_proj", "b_fc", "b_proj")
           if n in p}
    out["router.weight"] = _t(p["router"]["kernel"], transpose=True)
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


def audiobox_state_dict_from_jax(params: Mapping[str, Any],
                                config: AudioboxConfig | WavLMConfig
                                ) -> dict[str, torch.Tensor]:
    """The JAX Audiobox predictor's params (numpy leaves) -> the port's
    ``state_dict``: the inverse of the JAX package's
    ``eval/audiobox.py::convert_torch_state_dict``. ``Dense`` kernels are
    transposed, conv kernels (torch's [O, I/g, K] in both) and
    ``rel_attn_embed`` copied. A full predictor's tree (``AudioboxConfig``)
    gives :class:`AudioboxAesthetics`'s keys, a bare ``WavLMEncoder``'s
    (``WavLMConfig``) :class:`WavLMEncoder`'s. The output de-normalization
    (``out_mean``/``out_std``) is no part of the checkpoint layout: a tree
    whose values are not the identity (0, 1) raises, as does any leaf the
    mapping does not consume."""
    p = params["params"] if "params" in params else params
    flat = _flatten(p)
    full = isinstance(config, AudioboxConfig)
    wcfg = config.wavlm if full else config
    prefix = "encoder/" if full else ""
    out = {("wavlm." if full else "") + k: v
           for k, v in _wavlm_from_jax(flat, prefix, wcfg).items()}
    if full:
        for axis in config.axes:
            out[f"layer_weights_{axis}"] = _t(flat.pop(
                f"layer_weights_{axis}"))
            names = [f"head_{axis}_{j}" for j in range(
                len(config.head_hidden))] + [f"head_{axis}_out"]
            for j, name in enumerate(names):
                out[f"proj_{axis}.{2 * j}.weight"] = _t(
                    flat.pop(f"{name}/kernel"), transpose=True)
                out[f"proj_{axis}.{2 * j}.bias"] = _t(flat.pop(f"{name}/bias"))
            for name, identity in (("out_mean", 0.0), ("out_std", 1.0)):
                value = flat.pop(f"{name}_{axis}", identity)
                if float(np.asarray(value)) != identity:
                    raise ValueError(
                        f"{name}_{axis} = {float(np.asarray(value))}: the "
                        f"checkpoint layout has no key for it (set the "
                        f"port model's {name} buffer)")
    if flat:
        raise ValueError(f"params the mapping does not place: "
                         f"{sorted(flat)}")
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _wavlm_from_jax(flat: dict, prefix: str,
                    cfg: WavLMConfig) -> dict[str, torch.Tensor]:
    """The encoder's leaves (popped from ``flat`` under ``prefix``) under
    the HF ``WavLMModel`` names."""
    def take(path, transpose=False):
        return _t(flat.pop(prefix + path), transpose)

    def dense(path, name):
        out[name + ".weight"] = take(path + "/kernel", transpose=True)
        out[name + ".bias"] = take(path + "/bias")

    def norm(path, name):
        out[name + ".weight"] = take(path + "/scale")
        out[name + ".bias"] = take(path + "/bias")

    out = {}
    for i in range(len(cfg.conv_dim)):
        c = f"feature_extractor.conv_layers.{i}."
        out[c + "conv.weight"] = take(f"feature_encoder/conv_{i}_kernel")
        if cfg.conv_bias:
            out[c + "conv.bias"] = take(f"feature_encoder/conv_{i}_bias")
        if cfg.feat_extract_norm == "layer" or i == 0:
            out[c + "layer_norm.weight"] = take(
                f"feature_encoder/norm_{i}_scale")
            out[c + "layer_norm.bias"] = take(f"feature_encoder/norm_{i}_bias")
    norm("fp_layer_norm", "feature_projection.layer_norm")
    dense("fp_projection", "feature_projection.projection")
    out["encoder.pos_conv_embed.conv.weight"] = take("pos_conv_kernel")
    out["encoder.pos_conv_embed.conv.bias"] = take("pos_conv_bias")
    norm("layer_norm", "encoder.layer_norm")
    for i in range(cfg.num_layers):
        src, dst = f"layer_{i}/", f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj",
                     "gru_rel_pos_linear"):
            dense(src + "attention/" + name, dst + "attention." + name)
        out[dst + "attention.gru_rel_pos_const"] = take(
            src + "attention/gru_rel_pos_const")
        if i == 0:
            out[dst + "attention.rel_attn_embed.weight"] = take(
                src + "attention/rel_attn_embed")
        norm(src + "layer_norm", dst + "layer_norm")
        norm(src + "final_layer_norm", dst + "final_layer_norm")
        dense(src + "intermediate_dense",
              dst + "feed_forward.intermediate_dense")
        dense(src + "output_dense", dst + "feed_forward.output_dense")
    return out


@torch.no_grad()
def init_weights(model: GPT, generator: torch.Generator) -> GPT:
    """The JAX package's init in place: every Linear and Embedding weight
    N(0, 0.02), the residual projections (both ``c_proj``) N(0,
    0.02/sqrt(2*n_layer)), biases 0, LayerNorm scales 1; an MoE block's
    experts as its MLP would be (``w_fc`` N(0, 0.02), ``w_proj`` the
    residual std, biases 0) and its router N(0, 0.02) (JAX moe.py:54-78).
    ``generator`` must be on the model's device."""
    _init_modules(model, model.config.n_layer, generator)
    return model


def _init_modules(root: nn.Module, n_layer: int,
                  generator: torch.Generator) -> None:
    proj_std = 0.02 / math.sqrt(2 * n_layer)
    for name, module in root.named_modules():
        if isinstance(module, MoEMLP):
            module.w_fc.normal_(0.0, 0.02, generator=generator)
            module.w_proj.normal_(0.0, proj_std, generator=generator)
            for bias in (module.b_fc, module.b_proj):
                if bias is not None:
                    bias.zero_()
        elif isinstance(module, nn.Linear):
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
