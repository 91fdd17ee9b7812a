"""HF GPT-2 checkpoint import (parity: nanoGPT/model.py:206-261
from_pretrained): the port of ``ai_music_generation_tpu/models/hf_import.py``.

Maps a transformers ``GPT2LMHeadModel`` state dict onto the port's
:class:`~.gpt.GPT` state dict. HF's ``Conv1D`` weights are [in, out] and
the port's ``nn.Linear`` weights [out, in], so the four projections of each
block (``attn.c_attn``, ``attn.c_proj``, ``mlp.c_fc``, ``mlp.c_proj``) are
transposed, as nanoGPT's ``from_pretrained`` does (ref :236-256). HF's
causal-mask buffers (``attn.bias``, ``attn.masked_bias``) are not read, and
``lm_head`` stays tied to ``wte``.

``from_pretrained(name)`` reads a local directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``) with the port's own reader,
so the same code runs wherever the port runs, with or without
``transformers``; any other name resolves through transformers, as the JAX
package does (offline from a local HF cache; in a zero-egress environment
without one it raises).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

from ai_music_generation_tpu_torch.models.gpt import GPTConfig

# GPT-2 model zoo shapes (ref: nanoGPT/model.py:219-224)
GPT2_CONFIGS = {
    "gpt2": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, n_embd=1600),
}
# the HF Conv1D projections of a block, stored [in, out]
CONV1D = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
          "mlp.c_proj.weight")
BLOCK_KEYS = ("ln_1.weight", "ln_1.bias", "attn.c_attn.weight",
              "attn.c_attn.bias", "attn.c_proj.weight", "attn.c_proj.bias",
              "ln_2.weight", "ln_2.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
              "mlp.c_proj.weight", "mlp.c_proj.bias")
# safetensors dtype names (the format's header) -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _f32(t) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.detach().to("cpu", torch.float32)


def params_from_hf_state(state: Mapping[str, Any], config: GPTConfig
                         ) -> dict[str, torch.Tensor]:
    """HF GPT2LMHeadModel state dict (with or without the ``transformer.``
    prefix; torch tensors or arrays) -> the port GPT's state dict (fp32 CPU
    tensors, ``lm_head.weight`` the same tensor as ``wte``'s)."""
    prefix = ("transformer." if any(k.startswith("transformer.")
                                    for k in state) else "")

    def get(name):
        return _f32(state[prefix + name])

    sd = {"transformer.wte.weight": get("wte.weight"),
          "transformer.wpe.weight": get("wpe.weight"),
          "transformer.ln_f.weight": get("ln_f.weight"),
          "transformer.ln_f.bias": get("ln_f.bias")}
    for i in range(config.n_layer):
        for name in BLOCK_KEYS:
            t = get(f"h.{i}.{name}")
            sd[f"transformer.h.{i}.{name}"] = (t.T.contiguous()
                                               if name in CONV1D else t)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def config_from_hf(hf_config, dropout: float = 0.0) -> GPTConfig:
    """The port's GPTConfig of a HF GPT-2 config (a ``GPT2Config`` or the
    dict of its ``config.json``)."""
    get = (hf_config.__getitem__ if isinstance(hf_config, Mapping)
           else lambda k: getattr(hf_config, k))
    return GPTConfig(
        block_size=get("n_positions"),
        vocab_size=get("vocab_size"),
        n_layer=get("n_layer"),
        n_head=get("n_head"),
        n_embd=get("n_embd"),
        dropout=dropout,
        bias=True,
    )


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file (CPU tensors in their stored
    dtype): an 8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets}} (offsets into the bytes after the
    header; ``__metadata__`` skipped), then the raw little-endian data."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = info["data_offsets"]
            dtype = SAFETENSORS_DTYPES[info["dtype"]]
            if end == begin:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            f.seek(8 + n + begin)
            buf = bytearray(f.read(end - begin))
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(
                info["shape"])
    return out


def read_local(path: str) -> tuple[dict, dict[str, torch.Tensor]]:
    """(``config.json`` as a dict, the state dict) of a local HF GPT-2
    directory: ``model.safetensors`` if it is there, else
    ``pytorch_model.bin``."""
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return hf_config, read_safetensors(st)
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(pt):
        return hf_config, torch.load(pt, map_location="cpu",
                                     weights_only=True)
    raise FileNotFoundError(
        f"{path} holds neither model.safetensors nor pytorch_model.bin")


def _from_transformers(model_type: str):
    """(HF config, state dict) of a hub name through transformers (the JAX
    package's path and its errors)."""
    try:
        from transformers import GPT2LMHeadModel
    except ImportError as e:
        raise RuntimeError("transformers is required for from_pretrained") from e
    try:
        hf = GPT2LMHeadModel.from_pretrained(model_type)
    except Exception as e:
        raise RuntimeError(
            f"could not load {model_type!r} — in a zero-egress environment the "
            "weights must already be in the local HF cache or a local path"
        ) from e
    return hf.config, dict(hf.state_dict())


def from_pretrained(model_type: str, dropout: float = 0.0
                    ) -> tuple[GPTConfig, dict[str, torch.Tensor]]:
    """(model config, the port GPT's state dict) from a local directory or a
    HF hub name (ref contract: nanoGPT/model.py:206-261)."""
    if os.path.isdir(model_type):
        hf_config, state = read_local(model_type)
    else:
        hf_config, state = _from_transformers(model_type)
    config = config_from_hf(hf_config, dropout)
    # sanity-check known zoo names against the published shapes
    # (ref: nanoGPT/model.py:219-224) — a wrong local path masquerading as
    # a zoo name fails loudly here instead of training on the wrong model
    expect = GPT2_CONFIGS.get(model_type)
    if expect is not None:
        got = {k: getattr(config, k) for k in expect}
        if got != expect:
            raise ValueError(
                f"{model_type!r} loaded with shapes {got}, expected {expect}")
    return config, params_from_hf_state(state, config)
