"""GPT-2 style decoder in PyTorch: the port of
``ai_music_generation_tpu/models/gpt.py`` (inference path).

Module names follow nanoGPT (``transformer.wte``, ``transformer.h.{i}.attn.
c_attn``, ..., ``lm_head`` tied to ``wte``), so a state dict converted from
the JAX params (``models/convert.py``) or from a reference ``ckpt.pt`` loads
as is.

Numerics mirror the Flax modules: parameters stay in ``param_dtype`` (fp32)
and are cast to the compute ``dtype`` at each use, as Flax's ``Dense``,
``Embed`` and ``attend`` do; LayerNorm reduces in fp32 and returns
``dtype``; the MLP uses the tanh GELU (Flax's ``nn.gelu`` default); the
residual stream and the logits are in ``dtype``.

Decode runs over a flat lockstep :class:`KVCache`. A prefill (T > 1) writes
its slab and attends with plain torch ops (JAX runs it as XLA einsums, not
Pallas); every T=1 step goes through ``ops.gqa_decode.gqa_decode_update``,
which owns the column write and the attention (the CUDA kernel on a GPU,
its twin on the CPU).

Not ported yet: training (loss, MFU, remat, dropout), MoE, sequence
parallelism, and the ring and speculative cache modes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Same fields and defaults as the JAX ``GPTConfig``; ``dtype`` and
    ``param_dtype`` are torch dtypes. The port runs inference only, so
    ``dropout``, ``attn_impl``, ``remat`` and ``spec_int8_dots`` have no
    effect, and its cache is always flat (``flat_kv`` is accepted for
    configs carried over). ``n_expert > 0`` and ``seq_axis`` are refused by
    :class:`GPT`."""

    block_size: int = 1024
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "xla"
    kv_quantized: bool = False
    spec_int8_dots: bool = False
    remat: bool = False
    n_expert: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    n_kv_head: Optional[int] = None
    flat_kv: bool = False
    seq_axis: Optional[str] = None

    def __post_init__(self):
        if self.n_kv_head is not None and (
            self.n_kv_head < 1 or self.n_head % self.n_kv_head
        ):
            raise ValueError(
                f"n_kv_head={self.n_kv_head} must be a positive divisor of "
                f"n_head={self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        """Number of K/V heads (== n_head unless GQA is enabled)."""
        return self.n_kv_head or self.n_head


@dataclasses.dataclass
class KVCache:
    """Per-layer decode cache, lockstep flat mode (the JAX ``KVCache``
    with ``flat_kv``, models/gpt.py:207-229).

    ``k[i]``/``v[i]`` are layer i's [B, S, KH*D] buffers, int8 or the
    compute dtype; in int8 mode ``k_scale[i]``/``v_scale[i]`` are its
    [B, KH, S] bf16 per-(position, kv-head) scales. ``length`` is an int32
    0-dim tensor on the cache's device: the number of valid positions, shared
    by every row. It stays on the device so a decode step never syncs with
    the host.

    The model updates every buffer and ``length`` IN PLACE (the JAX model
    returns a new cache instead). Buffers start zeroed, like JAX's: columns
    past ``length`` are masked, and zeros keep a masked column finite.
    """

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    length: torch.Tensor
    k_scale: Optional[list[torch.Tensor]] = None
    v_scale: Optional[list[torch.Tensor]] = None

    @classmethod
    def create(cls, config: GPTConfig, batch: int,
               max_len: Optional[int] = None, device=None) -> "KVCache":
        """A zeroed cache of ``max_len`` (default block_size) positions:
        int8 with scales when ``config.kv_quantized``, else in
        ``config.dtype``."""
        max_len = max_len or config.block_size
        quantized = config.kv_quantized
        dtype = torch.int8 if quantized else config.dtype
        shape = (batch, max_len, config.kv_heads * config.head_dim)
        scale_shape = (batch, config.kv_heads, max_len)

        def bufs(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.n_layer)]

        return cls(
            k=bufs(shape, dtype), v=bufs(shape, dtype),
            length=torch.zeros((), dtype=torch.int32, device=device),
            k_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
            v_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
        )


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis (port of
    ``_quantize_int8``, bit-exact): fp32 abs-max, ``max(m, 1e-6) / 127``,
    round half to even, clip to +-127; returns (int8 values, bf16 scales)."""
    x = x.float()
    s = x.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(x / s[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def scale_write(buf: torch.Tensor, new_s: torch.Tensor, start) -> torch.Tensor:
    """Write a fresh [B, T, KH] scale slab into a [B, KH, S] scale buffer at
    columns ``start .. start+T-1``, in place (port of ``_scale_write``; the
    one-hot einsum there was a TPU lane-layout workaround). ``start`` may be
    an int or a device tensor; a tensor index keeps the write free of host
    syncs."""
    cols = start + torch.arange(new_s.shape[1], device=buf.device)
    buf[:, :, cols.long()] = new_s.transpose(1, 2).to(buf.dtype)
    return buf


def attend(q, k, v, k_scale, v_scale, mask):
    """Causal attention over a [B, S, KH, D] key/value view, the JAX model's
    ``cached_att`` chain (models/gpt.py:430-508) in the compute dtype of
    ``q`` [B, T, H, D]. Query head h reads kv-head h // G: the G heads of a
    group fold into the query-time axis, so one einsum serves MHA and GQA.
    int8 scales [B, KH, S] factor onto the scores and the probabilities.
    ``mask`` broadcasts to [B, 1, T, S] (True = attendable). Returns
    [B, T, H*D]."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    dtype = q.dtype
    # 1/sqrt(D) rounded to the compute dtype first, as jnp.asarray(., dtype)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=dtype).item()
    qf = q.reshape(B, T, KH, G, D).transpose(2, 3).reshape(B, T * G, KH, D)
    att = torch.einsum("bthd,bshd->bhts", qf, k.to(dtype)) * scale
    if k_scale is not None:
        att = att * k_scale[:, :, None, :].to(dtype)
    if mask.shape[2] != 1:
        mask = mask.repeat_interleave(G, dim=2)  # row t*G+g reads row t
    att = att.masked_fill(~mask, float("-inf"))
    att = torch.softmax(att.float(), dim=-1).to(dtype)
    if v_scale is not None:
        att = att * v_scale[:, :, None, :].to(dtype)
    y = torch.einsum("bhts,bshd->bthd", att, v.to(dtype))
    return y.reshape(B, T, G, KH, D).transpose(2, 3).reshape(B, T, H * D)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Flax ``Dense(dtype=...)``: weight and bias cast to x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=...)``: statistics in fp32, output in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C, KHD = config.n_embd, config.kv_heads * config.head_dim
        self.c_attn = nn.Linear(C, C + 2 * KHD, bias=config.bias,
                                dtype=config.param_dtype)
        self.c_proj = nn.Linear(C, C, bias=config.bias,
                                dtype=config.param_dtype)

    def forward(self, x, layer_cache=None, cache_len=None):
        """``layer_cache`` = (k, v, k_scale, v_scale) of this layer (scales
        None for a bf16 cache), updated in place at ``cache_len``."""
        cfg = self.config
        B, T, C = x.shape
        H, KH, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        KHD = KH * D
        q, k, v = _linear(x, self.c_attn).split([C, KHD, KHD], dim=-1)
        if layer_cache is None:
            # no-cache causal forward (JAX repeats K/V to H heads first;
            # attend groups the queries instead: the same dot products)
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            y = attend(q.reshape(B, T, H, D), k.reshape(B, T, KH, D),
                       v.reshape(B, T, KH, D), None, None, mask[None, None])
            return _linear(y, self.c_proj)
        ck, cv, ck_scale, cv_scale = layer_cache
        S = ck.shape[1]
        if T == 1:
            # decode step: in int8 mode the slabs stay raw (the op owns the
            # quantize and the scale write), else they take the cache dtype
            k_slab, v_slab = k.reshape(B, KHD), v.reshape(B, KHD)
            if ck_scale is None:
                k_slab, v_slab = k_slab.to(ck.dtype), v_slab.to(cv.dtype)
            y = gqa_decode_update(
                q.reshape(B, H, D).contiguous(), ck, cv, k_slab.contiguous(),
                v_slab.contiguous(), ck_scale, cv_scale, None, cache_len)
            return _linear(y.reshape(B, 1, C), self.c_proj)
        # prefill: slab write at cache_len (a device index, no host sync),
        # then the shared attention chain over the [B, S, KH, D] views
        cols = (cache_len + torch.arange(T, device=x.device)).long()
        if ck_scale is not None:
            kq, ks = quantize_int8(k.reshape(B, T, KH, D))
            vq, vs = quantize_int8(v.reshape(B, T, KH, D))
            ck[:, cols] = kq.reshape(B, T, KHD)
            cv[:, cols] = vq.reshape(B, T, KHD)
            scale_write(ck_scale, ks, cache_len)
            scale_write(cv_scale, vs, cache_len)
        else:
            ck[:, cols] = k.to(ck.dtype)
            cv[:, cols] = v.to(cv.dtype)
        mask = torch.arange(S, device=x.device)[None, :] <= cols[:, None]
        y = attend(q.reshape(B, T, H, D), ck.view(B, S, KH, D),
                   cv.view(B, S, KH, D), ck_scale, cv_scale, mask[None, None])
        return _linear(y, self.c_proj)


class MLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        C = config.n_embd
        self.c_fc = nn.Linear(C, 4 * C, bias=config.bias,
                              dtype=config.param_dtype)
        self.c_proj = nn.Linear(4 * C, C, bias=config.bias,
                                dtype=config.param_dtype)

    def forward(self, x):
        # Flax's nn.gelu is the tanh approximation
        return _linear(F.gelu(_linear(x, self.c_fc), approximate="tanh"),
                       self.c_proj)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        C = config.n_embd
        self.ln_1 = nn.LayerNorm(C, eps=1e-5, bias=config.bias,
                                 dtype=config.param_dtype)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = nn.LayerNorm(C, eps=1e-5, bias=config.bias,
                                 dtype=config.param_dtype)
        self.mlp = MLP(config)

    def forward(self, x, layer_cache=None, cache_len=None):
        x = x + self.attn(_layer_norm(x, self.ln_1), layer_cache, cache_len)
        return x + self.mlp(_layer_norm(x, self.ln_2))


class GPT(nn.Module):
    """Decoder-only LM with a weight-tied head.

    ``forward(idx, cache=None, return_all_logits=False)`` returns
    ``(logits, cache)``: logits in the compute dtype for the last position
    (or all positions with ``return_all_logits``); with a cache, the new
    tokens are written at ``cache.length`` and the same cache, updated in
    place, is returned.

    Weights: load a state dict (``models.convert.state_dict_from_jax``) or
    call ``models.convert.init_weights``; the constructor leaves torch's
    default initialisation.
    """

    def __init__(self, config: GPTConfig):
        super().__init__()
        if config.n_expert > 0 or config.seq_axis is not None:
            raise NotImplementedError(
                "MoE and sequence parallelism are not ported yet")
        self.config = config
        C, dt = config.n_embd, config.param_dtype
        self.transformer = nn.ModuleDict(dict(
            wte=nn.Embedding(config.vocab_size, C, dtype=dt),
            wpe=nn.Embedding(config.block_size, C, dtype=dt),
            h=nn.ModuleList(Block(config) for _ in range(config.n_layer)),
            ln_f=nn.LayerNorm(C, eps=1e-5, bias=config.bias, dtype=dt),
        ))
        self.lm_head = nn.Linear(C, config.vocab_size, bias=False, dtype=dt)
        self.transformer.wte.weight = self.lm_head.weight  # weight tying

    def forward(self, idx: torch.Tensor, cache: Optional[KVCache] = None,
                return_all_logits: bool = False):
        cfg = self.config
        B, T = idx.shape
        if T > cfg.block_size:
            raise ValueError(
                f"sequence length {T} exceeds block_size {cfg.block_size}")
        wte = self.transformer.wte.weight.to(cfg.dtype)
        pos = torch.arange(T, device=idx.device)
        if cache is not None:
            pos = pos + cache.length
        x = (F.embedding(idx, wte)
             + F.embedding(pos, self.transformer.wpe.weight.to(cfg.dtype)))
        for i, block in enumerate(self.transformer.h):
            layer_cache = None if cache is None else (
                cache.k[i], cache.v[i],
                None if cache.k_scale is None else cache.k_scale[i],
                None if cache.v_scale is None else cache.v_scale[i])
            x = block(x, layer_cache,
                      None if cache is None else cache.length)
        x = _layer_norm(x, self.transformer.ln_f)
        if cache is not None:
            cache.length += T
        if not return_all_logits:
            x = x[:, -1:]  # inference fast path: last position only
        return F.linear(x, wte), cache

    def num_params(self, non_embedding: bool = True) -> int:
        """Parameter count (the tied head counted once); optionally
        without the position embeddings."""
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.transformer.wpe.weight.numel()
        return n

    @torch.no_grad()
    def crop_block_size(self, block_size: int) -> None:
        """Model surgery: shrink the position table in place."""
        assert block_size <= self.config.block_size
        self.config = dataclasses.replace(self.config, block_size=block_size)
        wpe = self.transformer.wpe
        wpe.weight = nn.Parameter(wpe.weight[:block_size].clone())
        wpe.num_embeddings = block_size
