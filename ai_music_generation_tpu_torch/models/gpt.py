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

Decode runs over a flat :class:`KVCache`. In lockstep mode a prefill
(T > 1) writes its slab and attends with plain torch ops (JAX runs it as XLA
einsums, not Pallas). A T=1 step follows the JAX model's dispatch: with
``attn_impl="pallas"`` on a non-``flat_kv`` MHA cache in the compute dtype
it writes its column as the prefill does and attends through
``ops.decode_attention.decode_attention`` (the valid prefix only); every
other T=1 step goes through ``ops.gqa_decode.gqa_decode_update``, which owns
the column write and the attention. In speculative mode
(``KVCache.create(..., spec=True)``) every call, whatever its T, goes
through ``ops.spec_attention.spec_attention_update``, which owns the slab
write at the shared cursor and the attention under per-column logical
positions. Each op is the CUDA kernel on a GPU and its plain twin on the
CPU.

Not ported yet: training (loss, MFU, remat, dropout), MoE, sequence
parallelism, and the ring cache mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ai_music_generation_tpu_torch.ops.decode_attention import (
    decode_attention,
)
from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
from ai_music_generation_tpu_torch.ops.spec_attention import (
    spec_attention_update,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Same fields and defaults as the JAX ``GPTConfig``; ``dtype`` and
    ``param_dtype`` are torch dtypes. The port runs inference only, so
    ``dropout`` and ``remat`` have no effect. Its cache buffers are always
    flat [B, S, KH*D]; ``flat_kv`` and ``attn_impl`` pick the T=1 decode op
    as in the JAX model: ``flat_kv`` sends every T=1 step to
    ``ops.gqa_decode`` (K1) whatever ``attn_impl`` is; otherwise
    ``attn_impl="pallas"`` with MHA (``n_kv_head`` None or ``n_head``) and
    an unquantized cache sends it to ``ops.decode_attention`` (K4), and
    every other T=1 step goes to K1. ``attn_impl`` does not change the
    prefill or the no-cache forward (plain torch ops, as XLA einsums in
    JAX). ``spec_int8_dots`` selects the int8 x int8 products of the
    speculative verify attention on an int8 spec cache (on the CPU as
    well: there the op runs that mode's plain twin). ``n_expert > 0`` and
    ``seq_axis`` are refused by :class:`GPT`."""

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

    Speculative mode (``spec=True``, the JAX spec cache, models/gpt.py:
    230-287) keeps the same flat buffers with full multi-head K/V, but
    ``length`` is a [B] int32 vector, the logical position of each row's
    first query this call, and ``col_pos`` [B, S] int32 holds the logical
    position of every column (``INVALID_POS`` for a dead one). Every call
    writes all rows' T fresh columns as one slab at the shared ``cursor``
    (an int32 0-dim tensor), padded to the 8-aligned width Tw = ceil(T/8)*8;
    query t of row b reads column s iff ``col_pos[b, s] <= length[b] + t``.
    The model marks the T fresh columns with their positions and advances
    ``cursor`` by Tw and ``length`` by T; the caller re-marks rejected
    columns dead and rewinds ``length`` (decode/speculative.py).

    The model updates every buffer, ``length``, ``cursor`` and ``col_pos``
    IN PLACE (the JAX model returns a new cache instead). Buffers start
    zeroed, like JAX's: masked columns are never read, and zeros keep a
    masked column finite.
    """

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    length: torch.Tensor
    k_scale: Optional[list[torch.Tensor]] = None
    v_scale: Optional[list[torch.Tensor]] = None
    cursor: Optional[torch.Tensor] = None
    col_pos: Optional[torch.Tensor] = None

    # col_pos sentinel for dead columns: large and positive, so that
    # ``col_pos[s] <= q_pos`` is false for every real query position
    INVALID_POS: ClassVar[int] = 1 << 30

    @classmethod
    def create(cls, config: GPTConfig, batch: int,
               max_len: Optional[int] = None, device=None,
               spec: bool = False) -> "KVCache":
        """A zeroed cache of ``max_len`` (default block_size) positions:
        int8 with scales when ``config.kv_quantized``, else in
        ``config.dtype``; ``spec`` selects speculative mode (class
        docstring), which needs full multi-head K/V and ``max_len % 8 ==
        0``. ``device`` None allocates on the card, as the JAX cache lands
        on the accelerator, and raises when there is none; pass
        ``device="cpu"`` for a CPU cache."""
        max_len = max_len or config.block_size
        if spec:
            if max_len % 8:
                raise ValueError("spec cache length must be 8-aligned")
            if config.kv_heads != config.n_head:
                raise ValueError(
                    "the speculative verify attention needs full multi-head "
                    "K/V; decode GQA models with the plain Generator")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "KVCache.create allocates on the CUDA device by default "
                    "and none is available; pass device='cpu' for a CPU "
                    "cache")
            device = torch.device("cuda")
        quantized = config.kv_quantized
        dtype = torch.int8 if quantized else config.dtype
        shape = (batch, max_len, config.kv_heads * config.head_dim)
        scale_shape = (batch, config.kv_heads, max_len)

        def bufs(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.n_layer)]

        def i32(shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        return cls(
            k=bufs(shape, dtype), v=bufs(shape, dtype),
            length=i32((batch,) if spec else ()),
            k_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
            v_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
            cursor=i32(()) if spec else None,
            col_pos=i32((batch, max_len), cls.INVALID_POS) if spec else None,
        )


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device. PyTorch's
    CUDA kernels divide by a Python number as a product with its
    reciprocal, which can land one ulp away and flip a value quantized
    from it at a rounding tie; a 0-dim tensor on x's device divides."""
    return x / x.new_full((), d)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis (port of
    ``_quantize_int8``, bit-exact on the CPU and the card): fp32 abs-max,
    ``max(m, 1e-6) / 127``, round half to even, clip to +-127; returns
    (int8 values, bf16 scales)."""
    x = x.float()
    s = true_divide(x.abs().amax(dim=-1).clamp_min(1e-6), 127.0)
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

    def forward(self, x, layer_cache=None, cache_len=None, cursor=None,
                spec_col_pos=None):
        """``layer_cache`` = (k, v, k_scale, v_scale) of this layer (scales
        None for a bf16 cache), updated in place at ``cache_len`` or, in
        speculative mode (``spec_col_pos`` given), at ``cursor``."""
        cfg = self.config
        B, T, C = x.shape
        H, KH, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        KHD = KH * D
        q, k, v = _linear(x, self.c_attn).split([C, KHD, KHD], dim=-1)
        if spec_col_pos is not None:
            return self._spec_forward(q, k, v, layer_cache, cache_len,
                                      cursor, spec_col_pos)
        if layer_cache is None:
            # no-cache causal forward (JAX repeats K/V to H heads first;
            # attend groups the queries instead: the same dot products)
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            y = attend(q.reshape(B, T, H, D), k.reshape(B, T, KH, D),
                       v.reshape(B, T, KH, D), None, None, mask[None, None])
            return _linear(y, self.c_proj)
        ck, cv, ck_scale, cv_scale = layer_cache
        S = ck.shape[1]
        # K4 (JAX gpt.py:719-734, reached only off the flat branch)
        prefix_step = (T == 1 and cfg.attn_impl == "pallas"
                       and not cfg.flat_kv and ck_scale is None and KH == H)
        if T == 1 and not prefix_step:
            # decode step: in int8 mode the slabs stay raw (the op owns the
            # quantize and the scale write), else they take the cache dtype
            k_slab, v_slab = k.reshape(B, KHD), v.reshape(B, KHD)
            if ck_scale is None:
                k_slab, v_slab = k_slab.to(ck.dtype), v_slab.to(cv.dtype)
            y = gqa_decode_update(
                q.reshape(B, H, D).contiguous(), ck, cv, k_slab.contiguous(),
                v_slab.contiguous(), ck_scale, cv_scale, None, cache_len)
            return _linear(y.reshape(B, 1, C), self.c_proj)
        # prefill (and the K4 step): slab write at cache_len (a device
        # index, no host sync), as JAX's dynamic_update_slice
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
        if prefix_step:
            # the step's query attends over the cache_len + 1 valid columns
            y = decode_attention(q.reshape(B, C).contiguous(), ck, cv,
                                 cache_len + 1, n_head=H)
            return _linear(y.reshape(B, 1, C), self.c_proj)
        # the shared attention chain over the [B, S, KH, D] views
        mask = torch.arange(S, device=x.device)[None, :] <= cols[:, None]
        y = attend(q.reshape(B, T, H, D), ck.view(B, S, KH, D),
                   cv.view(B, S, KH, D), ck_scale, cv_scale, mask[None, None])
        return _linear(y, self.c_proj)

    def _spec_forward(self, q, k, v, layer_cache, lengths, cursor, col_pos):
        """Speculative mode (JAX models/gpt.py:515-589): the fresh K/V slab,
        padded with zero columns to Tw = ceil(T/8)*8 and (int8 mode)
        quantized per (column, head) with its scales written into the
        window ``[cursor, cursor+Tw)``, goes to ``spec_attention_update``,
        which writes it at ``cursor`` and attends under ``col_pos``. The
        zero pad columns quantize to scale bf16(1e-6/127), as in JAX; they
        stay dead in ``col_pos``."""
        cfg = self.config
        B, T, C = q.shape
        H, D = cfg.n_head, cfg.head_dim
        ck, cv, ck_scale, cv_scale = layer_cache
        Tw = -(-T // 8) * 8
        k, v = (F.pad(t, (0, 0, 0, Tw - T)) for t in (k, v))
        if ck_scale is not None:
            kq, ks = quantize_int8(k.reshape(B, Tw, H, D))
            vq, vs = quantize_int8(v.reshape(B, Tw, H, D))
            scale_write(ck_scale, ks, cursor)
            scale_write(cv_scale, vs, cursor)
            k_slab, v_slab = kq.reshape(B, Tw, C), vq.reshape(B, Tw, C)
        else:
            k_slab, v_slab = k.to(ck.dtype), v.to(cv.dtype)
        y = spec_attention_update(
            q.contiguous(), ck, cv, k_slab.contiguous(), v_slab.contiguous(),
            ck_scale, cv_scale, col_pos, lengths, cursor, n_head=H,
            int8_dots=cfg.spec_int8_dots and ck_scale is not None)
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

    def forward(self, x, layer_cache=None, cache_len=None, cursor=None,
                spec_col_pos=None):
        x = x + self.attn(_layer_norm(x, self.ln_1), layer_cache, cache_len,
                          cursor, spec_col_pos)
        return x + self.mlp(_layer_norm(x, self.ln_2))


class GPT(nn.Module):
    """Decoder-only LM with a weight-tied head.

    ``forward(idx, cache=None, return_all_logits=False)`` returns
    ``(logits, cache)``: logits in the compute dtype for the last position
    (or all positions with ``return_all_logits``); with a cache, the new
    tokens are written at ``cache.length`` (speculative mode: at
    ``cache.cursor``, see :class:`KVCache`) and the same cache, updated in
    place, is returned.

    Weights: load a state dict (``models.convert.state_dict_from_jax``) or
    call ``models.convert.init_weights``; the constructor leaves torch's
    default initialisation. ``device`` None creates the parameters on the
    card, as ``KVCache.create`` allocates, and raises when there is none;
    pass ``device="cpu"`` for a CPU model.
    """

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        if config.n_expert > 0 or config.seq_axis is not None:
            raise NotImplementedError(
                "MoE and sequence parallelism are not ported yet")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "GPT creates its parameters on the CUDA device by default "
                    'and none is available; pass device="cpu" for a CPU '
                    "model")
            device = torch.device("cuda")
        self.config = config
        C, dt = config.n_embd, config.param_dtype
        with torch.device(device):  # every parameter is created there
            self.transformer = nn.ModuleDict(dict(
                wte=nn.Embedding(config.vocab_size, C, dtype=dt),
                wpe=nn.Embedding(config.block_size, C, dtype=dt),
                h=nn.ModuleList(Block(config) for _ in range(config.n_layer)),
                ln_f=nn.LayerNorm(C, eps=1e-5, bias=config.bias, dtype=dt),
            ))
            self.lm_head = nn.Linear(C, config.vocab_size, bias=False,
                                     dtype=dt)
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
        spec_col_pos = None
        if cache is not None and cache.col_pos is not None:
            # speculative mode (JAX gpt.py:902-919): query t of row b sits
            # at length[b] + t; the T fresh columns at the cursor are
            # tentatively marked with those positions (the caller re-marks
            # rejected ones), the pad columns past them stay dead
            pos = cache.length[:, None] + pos.to(torch.int32)  # [B, T]
            rel = (torch.arange(cache.col_pos.shape[1], device=idx.device,
                                dtype=torch.int32) - cache.cursor)
            spec_col_pos = torch.where(
                (rel >= 0) & (rel < T), cache.length[:, None] + rel,
                cache.col_pos)
        elif cache is not None:
            pos = pos + cache.length
        x = (F.embedding(idx, wte)
             + F.embedding(pos, self.transformer.wpe.weight.to(cfg.dtype)))
        for i, block in enumerate(self.transformer.h):
            layer_cache = None if cache is None else (
                cache.k[i], cache.v[i],
                None if cache.k_scale is None else cache.k_scale[i],
                None if cache.v_scale is None else cache.v_scale[i])
            x = block(x, layer_cache,
                      None if cache is None else cache.length,
                      None if cache is None else cache.cursor, spec_col_pos)
        x = _layer_norm(x, self.transformer.ln_f)
        if spec_col_pos is not None:
            # JAX gpt.py:981-998: the cursor advances by the 8-aligned
            # write width, the length as if every token were accepted
            cache.col_pos = spec_col_pos
            cache.cursor += -(-T // 8) * 8
            cache.length += T
        elif cache is not None:
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
