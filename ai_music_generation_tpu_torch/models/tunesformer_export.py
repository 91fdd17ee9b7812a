"""The port's :class:`~.tunesformer.TunesFormer` out to a reference
``weights.pth``: the port of ``ai_music_generation_tpu/models/
tunesformer_export.py``, the inverse of ``models/tunesformer_import.py``.

The file loads in the reference's generate.py (``torch.load(...)["model"]``
into its TunesFormer module) and in the JAX package's
``load_reference_checkpoint``, to the same parameters. Layout (mirror of
the import):
- ``patch_level_decoder.patch_embedding.weight`` is the gather table
  transposed ([n_embd, patch_size*128], a torch Linear's weight);
- the HF blocks' four ``Conv1D`` projections are stored [in, out]: the
  port's Linear weights transposed;
- ``char_level_decoder.base.lm_head.weight`` is the char ``wte`` (tied:
  one tensor under both keys);
- without shared weights the patch core's HF ``wte`` ([1, n_embd], never
  read: the reference feeds ``inputs_embeds``) is zeros; with them the
  reference aliases ``patch_level_decoder.base`` to the char transformer,
  so both prefixes carry the same tensors, and the patch ``wte`` is the
  char ``wte``;
- the keys run in the reference module's parameter order (the patch
  embedding, the patch base, the char transformer, the head), so the
  optimizer state's indices (:func:`~.tunesformer_import.unique_keys`) are
  the ones the reference trainer gives its parameters.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.models.tunesformer_import import (
    CHAR_PREFIX, LM_HEAD, PATCH_PREFIX, reference_key, unique_keys,
)

PATCH_EMBEDDING = "patch_level_decoder.patch_embedding."


def reference_layout(named: dict[str, torch.Tensor], config
                      ) -> dict[str, torch.Tensor]:
    """Port-named tensors (the parameters, or one of their moments) under
    their reference keys in the reference's order, transposed where the
    reference stores them transposed."""
    share = config.share_weights
    ref = {}
    for name, t in named.items():
        key, transposed = reference_key(name, share)
        ref[key] = t.T.contiguous() if transposed else t
    wte = ref.pop((PATCH_PREFIX if share else CHAR_PREFIX) + "wte.weight")
    out = {PATCH_EMBEDDING + "weight": ref.pop(PATCH_EMBEDDING + "weight"),
           PATCH_EMBEDDING + "bias": ref.pop(PATCH_EMBEDDING + "bias"),
           PATCH_PREFIX + "wte.weight":
               wte if share else torch.zeros(1, config.n_embd)}
    patch = {k: v for k, v in ref.items() if k.startswith(PATCH_PREFIX)}
    out.update(patch)
    out[CHAR_PREFIX + "wte.weight"] = wte
    if share:
        out.update({CHAR_PREFIX + k[len(PATCH_PREFIX):]: v
                    for k, v in patch.items()})
    else:
        out.update({k: v for k, v in ref.items()
                    if k.startswith(CHAR_PREFIX)})
    out[LM_HEAD] = wte
    return out


def tunesformer_state_from_port(model: TunesFormer
                                ) -> dict[str, torch.Tensor]:
    """The reference TunesFormer state dict (fp32 CPU tensors; tied and
    aliased keys share one tensor) of ``model``'s parameters."""
    return reference_layout(
        {k: v.detach().to("cpu", torch.float32).clone()
         for k, v in model.named_parameters()}, model.config)


def save_reference_checkpoint(path: str, model: TunesFormer, epoch: int = 0,
                              best_epoch: int = 0,
                              min_eval_loss: float = 100.0,
                              optimizer: Optional[torch.optim.Optimizer]
                              = None, base_lr: float = 5e-5,
                              lr: Optional[float] = None) -> None:
    """Write a ``weights.pth`` with the reference's checkpoint keys
    (``model``, ``optimizer``, ``lr_sched``, ``epoch``, ``best_epoch``,
    ``min_eval_loss``) plus ``model_args`` (the config's architecture: a
    resume or a load needs ``patch_length`` and ``n_head``, which the
    shapes do not hold) and ``update_count``.

    ``optimizer`` None: a fresh AdamW (lr ``base_lr``) over the distinct
    tensors, as the reference sets it up. Else the port's AdamW over
    ``model`` (``train/optimizer.py::optax_adamw``): its moments and step
    count as torch AdamW's state, in the reference's order and layout
    (moments transposed as their weights are; the unused patch ``wte`` has
    none, as in the reference), its hyperparameters, and ``lr`` (the
    schedule's current value) in the group and the LambdaLR state (base lr
    ``base_lr``, at the update count)."""
    cfg = model.config
    tensors = tunesformer_state_from_port(model)
    keys = unique_keys(tensors, cfg.share_weights)
    params = [torch.nn.Parameter(tensors[k].clone()) for k in keys]
    count = 0
    if optimizer is None:
        opt = torch.optim.AdamW(params, lr=base_lr)
    else:
        (group,) = optimizer.param_groups
        opt = torch.optim.AdamW(params, lr=base_lr, betas=group["betas"],
                                eps=group["eps"],
                                weight_decay=group["weight_decay"])
        named = dict(model.named_parameters())
        moments = {
            m: reference_layout({n: optimizer.state[p][m].detach().to(
                "cpu", torch.float32) for n, p in named.items()}, cfg)
            for m in ("exp_avg", "exp_avg_sq")}
        steps = {reference_key(n, cfg.share_weights)[0]:
                 optimizer.state[p]["step"].detach().to("cpu", torch.float32)
                 for n, p in named.items()}
        count = int(next(iter(steps.values())))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    opt_state, sched_state = opt.state_dict(), sched.state_dict()
    if optimizer is not None:
        opt_state["state"] = {
            i: {"step": steps[k], "exp_avg": moments["exp_avg"][k],
                "exp_avg_sq": moments["exp_avg_sq"][k]}
            for i, k in enumerate(keys) if k in steps}
        if lr is not None:
            opt_state["param_groups"][0]["lr"] = float(lr)
            sched_state["_last_lr"] = [float(lr)]
        sched_state["last_epoch"] = count
        sched_state["_step_count"] = count + 1
    model_args = dict(
        patch_length=cfg.patch_length, patch_size=cfg.patch_size,
        patch_layers=cfg.patch_layers, char_layers=cfg.char_layers,
        n_embd=cfg.n_embd, n_head=cfg.n_head,
        share_weights=cfg.share_weights)
    torch.save({"model": tensors, "optimizer": opt_state,
                "lr_sched": sched_state, "epoch": int(epoch),
                "best_epoch": int(best_epoch),
                "min_eval_loss": float(min_eval_loss),
                "model_args": model_args, "update_count": count}, path)
