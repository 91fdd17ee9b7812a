"""The nanoGPT ``ckpt.pt`` format for the port's GPT: the torch-native
counterpart of ``ai_music_generation_tpu/models/nanogpt_ckpt.py``.

A reference trainer persists {model state_dict, optimizer state_dict,
model_args, iter_num, best_val_loss, config} as ``ckpt.pt``. The port's
module names and layouts are nanoGPT's (``models/gpt.py``), so a load is a
``load_state_dict`` and a save a ``state_dict``; what this module adds is the
format around them:

- load strips torch.compile's ``_orig_mod.`` key prefix and drops the
  causal-mask buffers ``*.attn.bias`` / ``*.attn.masked_bias`` that a
  non-flash reference build registers; a state without ``lm_head.weight``
  takes it from the tied ``transformer.wte.weight``;
- the config comes from ``model_args`` (``n_kv_head`` too, when a GQA
  checkpoint carries it, and ``MOE_KEYS`` when an MoE one does);
- save writes the full key set with the tied ``lm_head.weight`` sharing
  ``transformer.wte.weight``'s storage, the trainer's AdamW state (on the
  CPU) or, without one, a fresh AdamW state with nanoGPT's decay /
  no-decay groups (so a reference resume loads it), ``model_args``
  (with ``n_kv_head`` for a GQA model, which the JAX
  ``load_reference_ckpt`` reads with an ``n_kv_head`` override, and
  ``MOE_KEYS`` for an MoE model, as the JAX trainer writes them), and
  ``iter_num``, ``best_val_loss`` and the training ``config`` (whose
  ``dataset`` names the codec's meta.pkl).

An MoE model's state dict holds the port's ``transformer.h.{i}.moe.*``
parameters in place of ``mlp.*``: nanoGPT has no MoE layer
(nanoGPT/model.py:78-92), so nanoGPT itself cannot load such a file (the
JAX exporter refuses MoE models for the same reason,
``nanogpt_ckpt.py:140-143``); the port's loaders and trainer read it.

``torch.load`` unpickles: load only checkpoints this program or a trusted
trainer wrote.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

# model_args persisted by the reference trainer
MODEL_ARGS_KEYS = ("n_layer", "n_head", "n_embd", "block_size", "bias",
                   "vocab_size")

# the MoE architecture, in model_args only when n_expert > 0 (JAX
# train/trainer.py:97-99, 151-152), so dense checkpoints keep nanoGPT's
# exact key set
MOE_KEYS = ("n_expert", "expert_top_k", "capacity_factor", "moe_aux_coef")

_ORIG_MOD = "_orig_mod."
_MASK_BUFFERS = (".attn.bias", ".attn.masked_bias")


def strip_compile_prefix(state: Mapping[str, Any]) -> dict[str, Any]:
    """Remove torch.compile's ``_orig_mod.`` prefix."""
    return {
        (k[len(_ORIG_MOD):] if k.startswith(_ORIG_MOD) else k): v
        for k, v in state.items()
    }


def config_from_model_args(model_args: Mapping[str, Any],
                           **overrides) -> GPTConfig:
    """GPTConfig from a checkpoint's model_args dict; ``n_kv_head`` and
    the ``MOE_KEYS`` are taken when present."""
    kwargs = {k: model_args[k] for k in MODEL_ARGS_KEYS}
    kwargs["dropout"] = float(model_args.get("dropout", 0.0))
    if model_args.get("n_kv_head") is not None:
        kwargs["n_kv_head"] = int(model_args["n_kv_head"])
    if model_args.get("n_expert"):
        kwargs.update({k: model_args[k] for k in MOE_KEYS})
    kwargs.update(overrides)
    return GPTConfig(**kwargs)


def read_ckpt(path: str) -> dict:
    """The ``ckpt.pt`` dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def model_state(ckpt: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The checkpoint's model state as the port's GPT loads it."""
    state = {k: v for k, v in strip_compile_prefix(ckpt["model"]).items()
             if not k.endswith(_MASK_BUFFERS)}
    state.setdefault("lm_head.weight", state["transformer.wte.weight"])
    return state


def load_ckpt(path: str, device=None, **config_overrides):
    """Read a ``ckpt.pt`` -> (GPT with its weights on ``device``, meta).

    ``config_overrides`` set runtime fields of the config (``dtype``,
    ``kv_quantized``, ``flat_kv``, ...); ``device`` None is the card, as
    :class:`GPT`. meta carries {model_args, iter_num, best_val_loss,
    config} as the JAX ``load_reference_ckpt`` returns them."""
    ckpt = read_ckpt(path)
    config = config_from_model_args(ckpt["model_args"], **config_overrides)
    model = GPT(config, device=device)
    model.load_state_dict(model_state(ckpt))
    meta = {
        "model_args": {k: ckpt["model_args"][k]
                       for k in MODEL_ARGS_KEYS + MOE_KEYS
                       if k in ckpt["model_args"]},
        "iter_num": int(ckpt.get("iter_num", 0)),
        "best_val_loss": float(ckpt.get("best_val_loss", 1e9)),
        "config": dict(ckpt.get("config", {})),
    }
    return model.eval(), meta


def _fresh_adamw_state_dict(params: list[torch.Tensor], learning_rate: float,
                            weight_decay: float, beta1: float,
                            beta2: float) -> dict:
    """A loadable AdamW state_dict with nanoGPT's param groups: group 0 the
    decayed (ndim >= 2), group 1 the rest, over the model's deduplicated
    parameters in state-dict order; the moments start empty."""
    decay = [torch.nn.Parameter(p.clone()) for p in params if p.dim() >= 2]
    nodecay = [torch.nn.Parameter(p.clone()) for p in params if p.dim() < 2]
    opt = torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": nodecay, "weight_decay": 0.0}],
        lr=learning_rate, betas=(beta1, beta2))
    return opt.state_dict()


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_ckpt(path: str, model: GPT, iter_num: int = 0,
              best_val_loss: float = 1e9,
              train_config: Optional[Mapping[str, Any]] = None,
              optimizer: Optional[torch.optim.Optimizer] = None,
              state: Optional[Mapping[str, torch.Tensor]] = None,
              optimizer_state: Optional[Mapping[str, Any]] = None) -> None:
    """Write ``model`` as a ``ckpt.pt`` (fp32 weights on the CPU).
    ``train_config`` is stored as the checkpoint's ``config`` (its
    ``dataset`` names the meta.pkl the sampling CLI decodes with).
    ``optimizer`` (the trainer's AdamW, ``train/optimizer.py``) is stored
    as its ``state_dict`` on the CPU; without one the checkpoint holds a
    fresh AdamW state. GQA models are written too: their ``c_attn`` is
    [C + 2*KH*D, C] and ``model_args`` carries ``n_kv_head``; so are MoE
    models, with ``MOE_KEYS`` in ``model_args`` (module docstring).
    ``state`` and ``optimizer_state`` (whole ``state_dict`` s on the CPU,
    a model split over a mesh gathers them: ``parallel/sharding.py``)
    replace ``model``'s and ``optimizer``'s; ``model`` then gives the
    config only."""
    config = model.config
    train_config = dict(train_config or {})
    model_args = {k: getattr(config, k) for k in MODEL_ARGS_KEYS}
    model_args["dropout"] = config.dropout
    if config.kv_heads != config.n_head:
        model_args["n_kv_head"] = config.n_kv_head
    if config.n_expert > 0:
        model_args.update({k: getattr(config, k) for k in MOE_KEYS})
    # one CPU tensor per parameter: the tied lm_head / wte share storage,
    # so torch.save writes it once and a loader sees the tie
    copies: dict[int, torch.Tensor] = {}
    weights = {}
    for name, t in (state if state is not None
                    else model.state_dict(keep_vars=True)).items():
        if id(t) not in copies:
            copies[id(t)] = t.detach().to("cpu", torch.float32).clone()
        weights[name] = copies[id(t)]
    if optimizer_state is None and optimizer is not None:
        optimizer_state = _to_cpu(optimizer.state_dict())
    ckpt = {
        "model": weights,
        "optimizer": _fresh_adamw_state_dict(
            list(copies.values()),
            learning_rate=float(train_config.get("learning_rate", 6e-4)),
            weight_decay=float(train_config.get("weight_decay", 0.1)),
            beta1=float(train_config.get("beta1", 0.9)),
            beta2=float(train_config.get("beta2", 0.95)))
        if optimizer_state is None else optimizer_state,
        "model_args": model_args,
        "iter_num": int(iter_num),
        "best_val_loss": float(best_val_loss),
        "config": train_config,
    }
    torch.save(ckpt, path)
