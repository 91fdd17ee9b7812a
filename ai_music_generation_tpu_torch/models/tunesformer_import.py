"""Reference TunesFormer checkpoints (``weights.pth``) into the port's
:class:`~.tunesformer.TunesFormer`: the port of
``ai_music_generation_tpu/models/tunesformer_import.py``.

The reference's state dict (its TunesFormer module: a patch decoder
``patch_level_decoder`` with a one-hot Linear and an HF ``GPT2Model``, a
char decoder ``char_level_decoder`` with an HF ``GPT2LMHeadModel``) maps
onto the port's modules:

- ``patch_level_decoder.patch_embedding`` (torch Linear, weight [n_embd,
  patch_size*128]) -> ``patch_embedding`` (the gather table [patch_size*128,
  n_embd]: the weight transposed; the bias as is);
- ``patch_level_decoder.base.*`` -> ``patch_core.*``;
  ``char_level_decoder.base.transformer.*`` -> ``char_core.*`` (with
  ``share_weights``: the latter -> ``core.*``; the reference's state then
  carries both prefixes on the same tensors), its ``wte`` -> ``char_wte``
  (the head is tied to it on both sides);
- the HF blocks use the port's module names; their ``Conv1D`` weights are
  [in, out] and the port's ``nn.Linear`` wants [out, in], so the four
  projections of each block are transposed;
- ``.attn.bias`` and ``.attn.masked_bias`` (HF's causal-mask buffers) are
  dropped; the patch core's HF ``wte`` ([1, n_embd], never read) too.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ai_music_generation_tpu_torch.models.tunesformer import TunesFormerConfig

PATCH_PREFIX = "patch_level_decoder.base."
CHAR_PREFIX = "char_level_decoder.base.transformer."
# the HF Conv1D projections of a block, stored [in, out]
CONV1D = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
          "mlp.c_proj.weight")
LM_HEAD = "char_level_decoder.base.lm_head.weight"


def reference_key(name: str, share_weights: bool) -> tuple[str, bool]:
    """(the reference key that holds the port parameter ``name``, whether
    the reference stores it transposed). With ``share_weights`` the shared
    core and ``char_wte`` are named by their first key in the reference's
    parameter order, under ``patch_level_decoder.base``."""
    if name.startswith("patch_embedding."):
        return "patch_level_decoder." + name, name.endswith(".weight")
    if name == "char_wte.weight":
        return (PATCH_PREFIX if share_weights else CHAR_PREFIX) \
            + "wte.weight", False
    head, _, rest = name.partition(".")
    prefix = CHAR_PREFIX if head == "char_core" else PATCH_PREFIX
    return prefix + rest, rest.split(".", 2)[-1] in CONV1D


def unique_keys(keys, share_weights: bool) -> list[str]:
    """The keys of a reference state dict (in its order) that name distinct
    tensors: the tied ``lm_head`` and, with ``share_weights``, the char
    transformer (the patch base under another name) are left out. Their
    positions index the reference optimizer's state."""
    return [k for k in keys if k != LM_HEAD
            and not (share_weights and k.startswith(CHAR_PREFIX))]


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _core_state(state: Mapping[str, Any], prefix: str, n_layer: int,
                out: str) -> dict[str, torch.Tensor]:
    sd = {out + "wpe.weight": _f32(state[prefix + "wpe.weight"]),
          out + "ln_f.weight": _f32(state[prefix + "ln_f.weight"]),
          out + "ln_f.bias": _f32(state[prefix + "ln_f.bias"])}
    for i in range(n_layer):
        h = f"h.{i}."
        for name in ("ln_1.weight", "ln_1.bias", "attn.c_attn.weight",
                     "attn.c_attn.bias", "attn.c_proj.weight",
                     "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
                     "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
                     "mlp.c_proj.bias"):
            t = _f32(state[prefix + h + name])
            sd[out + h + name] = t.T.contiguous() if name in CONV1D else t
    return sd


def port_state_from_reference(state: Mapping[str, Any],
                              config: TunesFormerConfig
                              ) -> dict[str, torch.Tensor]:
    """The reference TunesFormer state dict -> the port's ``state_dict``
    (fp32, CPU tensors) for ``config``; HF's mask buffers (``.attn.bias``,
    ``.attn.masked_bias``) are not read."""
    sd = {
        "patch_embedding.weight": _f32(
            state["patch_level_decoder.patch_embedding.weight"]).T.contiguous(),
        "patch_embedding.bias": _f32(
            state["patch_level_decoder.patch_embedding.bias"]),
        "char_wte.weight": _f32(state[CHAR_PREFIX + "wte.weight"]),
    }
    if config.share_weights:
        layers = max(config.patch_layers, config.char_layers)
        sd.update(_core_state(state, CHAR_PREFIX, layers, "core."))
    else:
        sd.update(_core_state(state, PATCH_PREFIX, config.patch_layers,
                              "patch_core."))
        sd.update(_core_state(state, CHAR_PREFIX, config.char_layers,
                              "char_core."))
    return sd


def read_reference(path: str) -> tuple[dict, dict]:
    """(the checkpoint dict, its model state dict) of a ``weights.pth``
    (``torch.load`` on the CPU; the reference saves the state under
    ``"model"``, a bare state dict is taken as is)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt, ckpt["model"]
    return {}, ckpt


def load_reference_checkpoint(path: str, config: TunesFormerConfig
                              ) -> dict[str, torch.Tensor]:
    """The port's state dict from a reference ``weights.pth``, after the
    configured architecture is held against the one its shapes imply
    (``config_from_reference_state``): a deeper checkpoint cut to fewer
    configured layers, or a ``share_weights`` mismatch, would otherwise
    load wrong weights without an error."""
    _, state = read_reference(path)
    inferred = config_from_reference_state(state)
    mismatches = {
        field: (getattr(config, field), getattr(inferred, field))
        for field in ("patch_size", "patch_layers", "char_layers", "n_embd",
                      "share_weights")
        if getattr(config, field) != getattr(inferred, field)
    }
    if mismatches:
        detail = ", ".join(f"{k}: configured {a} != checkpoint {b}"
                           for k, (a, b) in mismatches.items())
        raise ValueError(
            f"{path} does not match the configured architecture ({detail}); "
            "pass model args matching the checkpoint (load_tunesformer "
            "infers them via config_from_reference_state)")
    return port_state_from_reference(state, config)


def config_from_reference_state(
    state: Mapping[str, Any], patch_length: int = 128, n_head: int = 12,
    dtype: Any = None,
) -> TunesFormerConfig:
    """A TunesFormerConfig from a reference state dict's shapes.
    ``patch_length`` and ``n_head`` are not in the shapes: the defaults are
    the reference's published config. Shared weights show as a patch core
    whose ``wte`` is the 128-row char table and whose layer-0 LayerNorm
    equals the char core's."""
    w = state["patch_level_decoder.patch_embedding.weight"]
    n_embd, flat = int(w.shape[0]), int(w.shape[1])

    def n_layers(prefix):
        head = prefix + "h."
        return 1 + max(int(k[len(head):].split(".")[0]) for k in state
                       if k.startswith(head))

    patch_layers = n_layers(PATCH_PREFIX)
    char_layers = n_layers(CHAR_PREFIX)
    share = (int(state[PATCH_PREFIX + "wte.weight"].shape[0]) == 128
             and patch_layers == char_layers)
    if share:
        a = _f32(state[PATCH_PREFIX + "h.0.ln_1.weight"])
        b = _f32(state[CHAR_PREFIX + "h.0.ln_1.weight"])
        share = a.shape == b.shape and bool(torch.equal(a, b))
    kwargs: dict[str, Any] = {}
    if dtype is not None:
        kwargs["dtype"] = dtype
    return TunesFormerConfig(
        patch_length=patch_length, patch_size=flat // 128,
        patch_layers=patch_layers, char_layers=char_layers,
        n_embd=n_embd, n_head=n_head, share_weights=share, **kwargs)


def optimizer_state_from_reference(ckpt: Mapping[str, Any], model,
                                   optimizer: torch.optim.Optimizer) -> dict:
    """A ``state_dict`` for ``optimizer`` (the port's AdamW over ``model``,
    ``train/optimizer.py::optax_adamw``) from a ``weights.pth`` checkpoint's
    ``optimizer`` (torch AdamW's state over the reference's distinct
    tensors, :func:`unique_keys` order): each parameter's ``step``,
    ``exp_avg`` and ``exp_avg_sq``, the moments of ``Conv1D`` weights and
    of the patch embedding transposed back to the port's layout."""
    share = model.config.share_weights
    index = {k: i for i, k in enumerate(unique_keys(ckpt["model"], share))}
    saved = ckpt.get("optimizer", {}).get("state", {})
    name_of = {id(p): n for n, p in model.named_parameters()}
    state = {}
    for j, p in enumerate(p for g in optimizer.param_groups
                          for p in g["params"]):
        key, transposed = reference_key(name_of[id(p)], share)
        if index[key] not in saved:
            raise ValueError(f"the checkpoint holds no optimizer state for "
                             f"{key}")
        s = saved[index[key]]
        state[j] = {"step": _f32(s["step"])}
        for m in ("exp_avg", "exp_avg_sq"):
            state[j][m] = (_f32(s[m]).T.contiguous() if transposed
                           else _f32(s[m]))
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
