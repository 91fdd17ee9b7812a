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
  char ``wte``.
"""

from __future__ import annotations

import torch

from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.models.tunesformer_import import (
    CHAR_PREFIX, CONV1D, PATCH_PREFIX,
)


def _core_state(core_sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A port core's state dict (relative keys) in the HF layout."""
    return {k: (v.T.contiguous() if k.split(".", 2)[-1] in CONV1D else v)
            for k, v in core_sd.items()}


def tunesformer_state_from_port(model: TunesFormer
                                ) -> dict[str, torch.Tensor]:
    """The reference TunesFormer state dict (fp32 CPU tensors; tied and
    aliased keys share one tensor) of ``model``'s parameters."""
    cfg = model.config
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in model.state_dict().items()}

    def core(prefix):
        return _core_state({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)})

    char_wte = sd["char_wte.weight"]
    out = {
        "patch_level_decoder.patch_embedding.weight":
            sd["patch_embedding.weight"].T.contiguous(),
        "patch_level_decoder.patch_embedding.bias": sd["patch_embedding.bias"],
        CHAR_PREFIX + "wte.weight": char_wte,
        "char_level_decoder.base.lm_head.weight": char_wte,
    }
    if cfg.share_weights:
        for k, v in core("core.").items():
            out[PATCH_PREFIX + k] = v
            out[CHAR_PREFIX + k] = v
        out[PATCH_PREFIX + "wte.weight"] = char_wte
    else:
        for k, v in core("patch_core.").items():
            out[PATCH_PREFIX + k] = v
        for k, v in core("char_core.").items():
            out[CHAR_PREFIX + k] = v
        out[PATCH_PREFIX + "wte.weight"] = torch.zeros(1, cfg.n_embd)
    return out


def save_reference_checkpoint(path: str, model: TunesFormer, epoch: int = 0,
                              best_epoch: int = 0,
                              min_eval_loss: float = 100.0) -> None:
    """Write a ``weights.pth`` with the reference's checkpoint keys
    (``model``, ``optimizer``, ``lr_sched``, ``epoch``, ``best_epoch``,
    ``min_eval_loss``). The optimizer and schedule are fresh: one AdamW
    group (lr 5e-5) over the unique tensors, as the reference sets them up;
    generation reads only ``model``."""
    tensors = tunesformer_state_from_port(model)
    params = [torch.nn.Parameter(t.clone())
              for t in dict.fromkeys(tensors.values())]
    opt = torch.optim.AdamW(params, lr=5e-5)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    torch.save({"model": tensors, "optimizer": opt.state_dict(),
                "lr_sched": sched.state_dict(), "epoch": int(epoch),
                "best_epoch": int(best_epoch),
                "min_eval_loss": float(min_eval_loss)}, path)
