"""GPT-2 style decoder in PyTorch: the port of
``ai_music_generation_tpu/models/gpt.py``.

Module names follow nanoGPT (``transformer.wte``, ``transformer.h.{i}.attn.
c_attn``, ..., ``lm_head`` tied to ``wte``), so a state dict converted from
the JAX params (``models/convert.py``) or from a reference ``ckpt.pt`` loads
as is.

Numerics mirror the Flax modules: parameters stay in ``param_dtype`` (fp32)
and are cast to the compute ``dtype`` at each use, as Flax's ``Dense``,
``Embed`` and ``attend`` do; LayerNorm reduces in fp32 and returns
``dtype``; the MLP uses the tanh GELU (Flax's ``nn.gelu`` default); the
residual stream and the logits are in ``dtype``. Every per-use cast goes
through :func:`cast_param`, which counts the bytes the casts move.

While a profiler records, ``GPT.forward`` is the span ``gpt.forward`` and
each block's forward the span ``gpt.block`` (``utils/tracing.py``).

Decode runs over a flat :class:`KVCache`. In lockstep mode a prefill
(T > 1) writes its slab and attends with plain torch ops (JAX runs it as XLA
einsums, not Pallas). A T=1 step follows the JAX model's dispatch: with
``attn_impl="pallas"`` on a non-``flat_kv`` MHA cache in the compute dtype
it writes its column as the prefill does and attends through
``ops.decode_attention.decode_attention`` (the valid prefix only); every
other T=1 step goes through ``ops.gqa_decode.gqa_decode_update``, which owns
the column write and the attention. In ring mode (``KVCache.create(...,
per_row=True)``, the serving cache) every call is a T=1 step and goes
through ``gqa_decode_update`` with its ring mask. In speculative mode
(``KVCache.create(..., spec=True)``) every call, whatever its T, goes
through ``ops.spec_attention.spec_attention_update``, which owns the slab
write at the shared cursor and the attention under per-column logical
positions. Each op is the CUDA kernel on a GPU and its plain twin on the
CPU.

Training (JAX gpt.py:745-815, 930-1050, 1070-1095): ``GPT.forward(idx,
targets)`` returns all positions' logits and the mean cross-entropy
(:func:`cross_entropy_ignore_index`); dropout acts at the JAX model's four
sites in ``train()`` mode, each mask a counter hash of (the micro-step's
``dropout_key``, layer, site, element index) (:func:`dropout`), so it needs
no generator state and gives the same bits on the CPU and the card and
when ``remat`` recomputes a block; ``remat`` checkpoints each block
(``torch.utils.checkpoint``); :func:`estimate_mfu` is the PaLM formula over
:func:`peak_flops_for`'s peak of the card.

MoE (JAX gpt.py:843-848, 962-1007): with ``n_expert > 0`` each block's MLP
is ``models.moe.MoEMLP``, the forward sums its load-balance aux over the
layers and a loss with targets gains ``moe_aux_coef * aux / n_layer``.
Routing couples the tokens of a call (the experts' capacity is shared), so
every cache mode runs the MoE sublayer on all the call's tokens, as JAX
does.

On a (data, model) mesh (``parallel/sharding.py`` sets each split
module's ``layout``), the training forward (targets, no cache) runs this
rank's part: its rows of the batch; its heads (the fused ``c_attn`` output
keeps JAX's placement, a contiguous slice of the [C + 2*KH*D] columns, so
the q/k/v slab is gathered over the model axis and each rank takes its
heads from it), its MLP columns and its vocab slice of the tied
embedding, whose logits go to a cross-entropy over the vocab shards. The
masks index the single-card site by global coordinates, so a sharded step
drops what the single-card step drops, and the loss is each rank's share
of the global mean (its data-axis mean is the single-card loss). A cached
forward on a mesh (the sharded servers, ``serve/``) runs the same heads
over a cache that holds the rank's K/V heads (:meth:`CausalSelfAttention.
cache_heads`), and a vocab-split head gathers its logits, since sampling
reads every vocabulary entry.

Sequence parallelism (``seq_axis``, JAX gpt.py:742-756, 924-932,
1023-1049; ``parallel/sequence.py`` builds the layout): the rank holds a
contiguous chunk of every sequence, its positions offset by ``seq_rank *
T``, attention is ``ops/ring_attention.py`` over the seq group, and the
loss sums its total and its count over the seq and data groups. It is the
training path only, without dropout, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ai_music_generation_tpu_torch.ops.decode_attention import (
    decode_attention,
)
from ai_music_generation_tpu_torch.ops.dropout import (  # noqa: F401
    CounterDropout,
    dropout_keep,
)
from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
from ai_music_generation_tpu_torch.ops.ring_attention import ring_attention
from ai_music_generation_tpu_torch.ops.spec_attention import (
    spec_attention_update,
)
from ai_music_generation_tpu_torch.parallel.collectives import (
    all_reduce_,
    copy_to,
    gather_last,
    reduce_from,
)
from ai_music_generation_tpu_torch.utils import tracing
from ai_music_generation_tpu_torch.utils.hash32 import GOLDEN, M32, mix32, mul32


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Same fields and defaults as the JAX ``GPTConfig``; ``dtype`` and
    ``param_dtype`` are torch dtypes. ``dropout`` acts in ``train()`` mode
    on the no-cache forward; ``remat`` checkpoints each block there while
    gradients are recorded. ``attn_impl="flash"`` runs that forward's
    attention as ``scaled_dot_product_attention`` (JAX's stock TPU flash
    kernel) unless dropout is active. Its cache buffers are always
    flat [B, S, KH*D]; ``flat_kv`` and ``attn_impl`` pick the T=1 decode op
    as in the JAX model: ``flat_kv`` sends every T=1 step to
    ``ops.gqa_decode`` (K1) whatever ``attn_impl`` is; otherwise
    ``attn_impl="pallas"`` with MHA (``n_kv_head`` None or ``n_head``) and
    an unquantized cache sends it to ``ops.decode_attention`` (K4), and
    every other T=1 step goes to K1. ``attn_impl`` does not change the
    prefill (plain torch ops, as XLA einsums in JAX), and of the no-cache
    forward only ``"flash"`` does. ``spec_int8_dots`` selects the int8 x
    int8 products of the speculative verify attention on an int8 spec
    cache (on the CPU as well: there the op runs that mode's plain twin).
    ``n_expert > 0`` replaces every block's MLP with ``n_expert`` routed
    experts (``models/moe.py``: ``expert_top_k`` a token, buffers of
    ``capacity_factor`` x the balanced share, the aux loss weighted by
    ``moe_aux_coef``). ``seq_axis`` names the mesh axis the sequence is
    split over (``parallel/sequence.py``; the model's ``layout`` holds its
    group)."""

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

    Ring mode (``per_row=True``, the JAX per-row cache, models/gpt.py:
    130-146, 199-229; the serving path, serve/engine.py) keeps the same
    buffers, but ``length`` is a [B] int32 vector, row b's number of valid
    columns, and ``cursor`` (an int32 0-dim tensor) the column that every
    row's next token is written to. Row b's token sits at position
    ``length[b]``; its valid columns are the fresh one at the cursor and the
    ``length[b]`` columns behind it, those whose ring offset ``(cursor - s)
    mod S`` is at most ``length[b]``. Every call is one T=1 step: it writes
    all rows' column at the cursor, then advances ``cursor`` mod S and every
    ``length`` by one (the caller pins the lengths of idle rows). A prompt
    is prefilled on a lockstep cache and rolled into place by the caller.

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
               spec: bool = False, per_row: bool = False,
               kv_heads: Optional[int] = None) -> "KVCache":
        """A zeroed cache of ``max_len`` (default block_size) positions:
        int8 with scales when ``config.kv_quantized``, else in
        ``config.dtype``; ``spec`` selects speculative mode (class
        docstring), which needs full multi-head K/V and ``max_len % 8 ==
        0``; ``per_row`` selects ring mode. ``kv_heads`` (default the
        config's) is the number of K/V heads held: a rank's on a model axis
        (:meth:`CausalSelfAttention.cache_heads`). ``device`` None allocates
        on the card, as the JAX cache lands on the accelerator, and raises
        when there is none; pass ``device="cpu"`` for a CPU cache."""
        max_len = max_len or config.block_size
        if spec and per_row:
            raise ValueError("spec and per_row are two different modes")
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
        kv_heads = kv_heads or config.kv_heads
        shape = (batch, max_len, kv_heads * config.head_dim)
        scale_shape = (batch, kv_heads, max_len)

        def bufs(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.n_layer)]

        def i32(shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        return cls(
            k=bufs(shape, dtype), v=bufs(shape, dtype),
            length=i32((batch,) if spec or per_row else ()),
            k_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
            v_scale=bufs(scale_shape, torch.bfloat16) if quantized else None,
            cursor=i32(()) if spec or per_row else None,
            col_pos=i32((batch, max_len), cls.INVALID_POS) if spec else None,
        )


def ring_positions(cache: KVCache, T: int,
                   block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions [B, 1] and ``mask_rel`` [B, S] of a ring-mode step (JAX
    gpt.py:920-923, 620-627; the GPT's and TunesFormer's cores both call
    this): row b's token sits at ``length[b]``; its valid columns lie within
    ``length[b]`` ring steps behind the cursor, the fresh one included
    (offset 0). Positions are clipped to ``block_size - 1`` as JAX's
    ``nn.Embed`` gather clips: an idle row whose request filled its window
    sits at length == cache_len, which may be block_size (its output is
    discarded)."""
    if T != 1:
        raise ValueError(
            "a ring-mode (per_row) cache takes T=1 steps; prefill on a "
            "lockstep cache and roll it into place")
    pos = (cache.length[:, None] + torch.arange(
        T, device=cache.length.device, dtype=torch.int32)).clamp_max(
        block_size - 1)
    S = cache.k[0].shape[1]
    offset = (cache.cursor - torch.arange(S, device=cache.length.device)) % S
    return pos, (cache.length[:, None] - offset).to(torch.int32)


def advance(cache: KVCache, T: int) -> None:
    """After a lockstep or ring-mode call of T tokens: ``length`` grows by T
    and, in ring mode, the cursor wraps forward (JAX gpt.py:988-990)."""
    if cache.cursor is not None:
        cache.cursor.add_(T).remainder_(cache.k[0].shape[1])
    cache.length += T


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


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``p`` in ``dtype`` for one use (module docstring).
    ``cast_param.bytes`` counts what the casts move: ``numel x (source
    bytes + target bytes)`` for each cast that changes the dtype, nothing
    for one that does not. ``GPT.forward.calls`` counts the forwards, so
    their ratio is a forward's cast traffic. Both are process-wide Python
    counters, as the ops' ``.launches``, but count only while a profiler
    records (``tracing.recording``): untraced, a cast pays one flag read (a
    forward captured into a CUDA graph counts at capture only)."""
    if p.dtype == dtype:
        return p
    if tracing.recording():
        cast_param.bytes += p.numel() * (p.element_size() + dtype.itemsize)
    return p.to(dtype)


cast_param.bytes = 0


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Flax ``Dense(dtype=...)``: weight and bias cast to x's dtype."""
    bias = None if layer.bias is None else cast_param(layer.bias, x.dtype)
    return F.linear(x, cast_param(layer.weight, x.dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=...)``: statistics in fp32, output in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


# dropout sites: the embedding sum (JAX gpt.py:937), the attention
# probabilities (:784), after the attention's c_proj (:377) and after the
# MLP's c_proj (:815)
SITE_EMBED, SITE_ATTN_PROBS, SITE_ATTN_OUT, SITE_MLP_OUT = range(4)


def dropout_key(seed: int, it: int, micro: int = 0) -> int:
    """The 32-bit key of one micro-step's dropout masks, a hash of (seed,
    iteration, micro-step): the port's ``fold_in(fold_in(PRNGKey(seed),
    it), micro)`` (JAX train/trainer.py, train/step.py:71)."""
    h = mix32(mix32((seed & M32) ^ 0x243F6A88) ^ (it & M32))
    return mix32(h ^ mul32(micro & M32, GOLDEN))


def dropout(x: torch.Tensor, p: float, key: int, layer: int, site: int,
            layout=None, head0: int = 0,
            n_head: Optional[int] = None) -> torch.Tensor:
    """Flax ``nn.Dropout`` with the mask of :func:`dropout_keep`: kept
    values divided by 1 - p in x's dtype, the rest 0, through
    ``ops.dropout.CounterDropout`` (one kernel a site on the card, forward
    and backward; the plain twin on the CPU). On a mesh (``layout``) x is
    this rank's part of the site (:func:`site_block`); the mask is the
    single-card mask at those coordinates."""
    return CounterDropout.apply(x, p, key, layer, site,
                                *site_block(x.shape, layout, head0, n_head))


def site_block(shape, layout=None, head0: int = 0,
               n_head: Optional[int] = None) -> tuple:
    """(start, full) of this rank's part of a dropout site of ``shape``
    on a mesh: its rows of the data axis (dim 0) and, at the attention
    probabilities, the heads ``head0 ..`` of ``n_head`` (dim 1); (None,
    None), the whole site, without a ``layout``."""
    if layout is None:
        return None, None
    start = [layout.data_rank * shape[0]] + [0] * (len(shape) - 1)
    full = [shape[0] * layout.n_data, *shape[1:]]
    if n_head is not None:
        start[1], full[1] = head0, n_head
    return start, full


def vocab_embedding(ids: torch.Tensor, weight: torch.Tensor,
                    layout) -> torch.Tensor:
    """``F.embedding(ids, table)`` of a table whose rows (the vocab) are
    split over the model axis, ``weight`` this rank's slice: each rank
    looks up the ids in its slice, the rest are 0, and the sum over the
    axis is the whole lookup."""
    V = weight.shape[0]
    local = ids.long() - layout.model_rank * V
    inside = (local >= 0) & (local < V)
    rows = F.embedding(local.clamp(0, V - 1), weight)
    return reduce_from(torch.where(inside[..., None], rows, 0.0),
                       layout.model_group)


class CausalSelfAttention(nn.Module):
    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C, KHD = config.n_embd, config.kv_heads * config.head_dim
        self.c_attn = nn.Linear(C, C + 2 * KHD, bias=config.bias,
                                dtype=config.param_dtype)
        self.c_proj = nn.Linear(C, C, bias=config.bias,
                                dtype=config.param_dtype)

    def forward(self, x, layer_cache=None, cache_len=None, cursor=None,
                spec_col_pos=None, mask_rel=None, drop=None):
        """``layer_cache`` = (k, v, k_scale, v_scale) of this layer (scales
        None for a bf16 cache), updated in place at ``cache_len`` or, in
        speculative mode (``spec_col_pos`` given) and ring mode
        (``mask_rel`` [B, S] given: column s of row b is valid iff
        ``mask_rel[b, s] >= 0``), at ``cursor``. ``drop`` = (p, key, layer)
        turns dropout on (no-cache forward only)."""
        cfg = self.config
        B, T, C = x.shape
        H, KH, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        KHD = KH * D
        if self.layout is not None:
            if spec_col_pos is not None:
                raise ValueError("speculative decoding does not run on a "
                                 "mesh")
            if layer_cache is None:
                return self._sharded_forward(x, drop)
            # this rank's heads and its K/V heads for them (cache_heads)
            qkv, h0, H, heads_split = self._mesh_qkv(x)
            kv0, KH = self._cache_kv(h0, H, heads_split)
            q = qkv[..., h0 * D:(h0 + H) * D]
            k = qkv[..., C + kv0 * D:C + (kv0 + KH) * D]
            v = qkv[..., C + KHD + kv0 * D:C + KHD + (kv0 + KH) * D]
            KHD = KH * D
            out = functools.partial(self._mesh_out, heads_split=heads_split)
        else:
            q, k, v = _linear(x, self.c_attn).split([C, KHD, KHD], dim=-1)
            out = functools.partial(_linear, layer=self.c_proj)
        if spec_col_pos is not None:
            return self._spec_forward(q, k, v, layer_cache, cache_len,
                                      cursor, spec_col_pos)
        if layer_cache is None:
            y = self._causal(q.reshape(B, T, H, D), k.reshape(B, T, KH, D),
                             v.reshape(B, T, KH, D), drop)
            y = _linear(y, self.c_proj)
            if drop is not None:
                y = dropout(y, *drop, SITE_ATTN_OUT)
            return y
        HD = H * D
        ck, cv, ck_scale, cv_scale = layer_cache
        S = ck.shape[1]
        # K4 (JAX gpt.py:719-734, reached only off the flat branch)
        # (never in ring mode: JAX returns from its ring branch before it)
        prefix_step = (T == 1 and cfg.attn_impl == "pallas"
                       and mask_rel is None and not cfg.flat_kv
                       and ck_scale is None and KH == H)
        if T == 1 and not prefix_step:
            # decode step: in int8 mode the slabs stay raw (the op owns the
            # quantize and the scale write), else they take the cache dtype
            k_slab, v_slab = k.reshape(B, KHD), v.reshape(B, KHD)
            if ck_scale is None:
                k_slab, v_slab = k_slab.to(ck.dtype), v_slab.to(cv.dtype)
            y = gqa_decode_update(
                q.reshape(B, H, D).contiguous(), ck, cv, k_slab.contiguous(),
                v_slab.contiguous(), ck_scale, cv_scale, mask_rel,
                cache_len if mask_rel is None else cursor)
            return out(y.reshape(B, 1, HD))
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
            y = decode_attention(q.reshape(B, HD).contiguous(), ck, cv,
                                 cache_len + 1, n_head=H)
            return out(y.reshape(B, 1, HD))
        # the shared attention chain over the [B, S, KH, D] views
        mask = torch.arange(S, device=x.device)[None, :] <= cols[:, None]
        y = attend(q.reshape(B, T, H, D), ck.view(B, S, KH, D),
                   cv.view(B, S, KH, D), ck_scale, cv_scale, mask[None, None])
        return out(y)

    def cache_heads(self) -> int:
        """The K/V heads a cache of this rank holds: its share when its
        query heads split over the model axis, else all. Raises when the
        K/V heads cannot split as the query heads do."""
        H, n = self.config.n_head, self.layout.n_model
        if not self._heads_split():
            return self.config.kv_heads
        return self._cache_kv(self.layout.model_rank * (H // n), H // n,
                              True)[1]

    def _heads_split(self) -> bool:
        return ("c_proj.weight" in self.split
                and self.config.n_head % self.layout.n_model == 0)

    def _cache_kv(self, h0: int, Hl: int, heads_split: bool):
        """(first K/V head, count) that query heads ``h0 .. h0+Hl-1`` read."""
        cfg = self.config
        KH, n = cfg.kv_heads, self.layout.n_model
        if not heads_split:
            return 0, KH
        if KH % n:
            G = cfg.n_head // KH
            raise ValueError(
                f"n_kv_head={KH} does not split over a model axis of {n}: "
                f"rank {self.layout.model_rank}'s query heads {h0}.."
                f"{h0 + Hl - 1} read K/V heads {h0 // G}..{(h0 + Hl - 1) // G}"
                f", which other ranks read too; serve on a model axis that "
                f"divides n_kv_head")
        return self.layout.model_rank * (KH // n), KH // n

    def _mesh_qkv(self, x):
        """The fused ``c_attn`` output of every head on this rank (gathered
        when its columns are split: JAX's placement slices the [C + 2*KH*D]
        columns contiguously, mixing q, k and v), and (h0, Hl, heads_split):
        the rank's query heads ``h0 .. h0+Hl-1``, all of them when the axis
        does not divide them."""
        lay = self.layout
        group, n, r = lay.model_group, lay.n_model, lay.model_rank
        attn_split = "c_attn.weight" in self.split
        proj_split = "c_proj.weight" in self.split
        if attn_split:  # its columns: each rank's dx is partial
            x = copy_to(x, group)
        qkv = _linear(x, self.c_attn)
        if attn_split:
            qkv = gather_last(qkv, group, sum_grad=proj_split)
        elif proj_split:  # the ranks use the replicated slab differently
            qkv = copy_to(qkv, group)
        heads_split = self._heads_split()
        H = self.config.n_head
        h0, Hl = (r * (H // n), H // n) if heads_split else (0, H)
        return qkv, h0, Hl, heads_split

    def _mesh_out(self, y, heads_split: bool):
        """``c_proj`` of the rank's attention output ``y``: whole, or its
        rows of the row-parallel projection (its heads' columns of y), the
        partial outputs summed over the model axis."""
        lay = self.layout
        if "c_proj.weight" not in self.split:
            return _linear(y, self.c_proj)
        if not heads_split:  # its rows of c_proj's input
            Cl = self.config.n_embd // lay.n_model
            y = y[..., lay.model_rank * Cl:(lay.model_rank + 1) * Cl]
        y = reduce_from(F.linear(y, cast_param(self.c_proj.weight, y.dtype)),
                        lay.model_group)
        if self.c_proj.bias is not None:
            y = y + cast_param(self.c_proj.bias, y.dtype)
        return y

    def _sharded_forward(self, x, drop):
        """The no-cache forward of this rank's part on a mesh. The fused
        ``c_attn`` output is split over the model axis in contiguous column
        slices (JAX's placement), which mix q, k and v: the slabs are
        gathered, and each rank attends with its heads (all heads when the
        axis does not divide them) and its K/V heads for them, then runs
        its rows of the row-parallel ``c_proj``; the axis sums the
        partial outputs."""
        cfg, lay = self.config, self.layout
        B, T, C = x.shape
        H, KH, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        qkv, h0, Hl, heads_split = self._mesh_qkv(x)
        kv = torch.arange(h0, h0 + Hl, device=x.device) // (H // KH)
        q = qkv[..., h0 * D:(h0 + Hl) * D].reshape(B, T, Hl, D)
        k = qkv[..., C:C + KH * D].reshape(B, T, KH, D).index_select(2, kv)
        v = qkv[..., C + KH * D:].reshape(B, T, KH, D).index_select(2, kv)
        y = self._mesh_out(self._causal(q, k, v, drop, h0), heads_split)
        if drop is not None:
            y = dropout(y, *drop, SITE_ATTN_OUT, lay)
        return y

    def _causal(self, q, k, v, drop, head0=0):
        """No-cache causal attention (JAX gpt.py:745-786): K/V repeated to
        the H query heads, then ``scaled_dot_product_attention`` for
        ``attn_impl="flash"`` without active dropout (the counterpart of
        JAX's stock flash kernel), else the einsum chain with fp32 softmax
        and dropout on the probabilities. [B, T, H, D] -> [B, T, H*D]; on a
        mesh the heads are ``head0 ..`` of ``n_head``. With ``seq_axis`` the
        chunk's attention is the ring over the seq group (JAX
        gpt.py:742-756)."""
        cfg = self.config
        B, T, H, D = q.shape
        G = H // k.shape[2]
        if G > 1:
            k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        if cfg.seq_axis is not None:
            return ring_attention(q, k, v, self.layout.seq_group).reshape(
                B, T, H * D)
        if cfg.attn_impl == "flash" and drop is None:
            y = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)
            return y.transpose(1, 2).reshape(B, T, H * D)
        scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype).item()
        att = torch.einsum("bthd,bshd->bhts", q, k) * scale
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~mask, float("-inf"))
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        if drop is not None:
            att = dropout(att, *drop, SITE_ATTN_PROBS, self.layout, head0,
                          cfg.n_head)
        return torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, H * D)

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
    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config: GPTConfig):
        super().__init__()
        C = config.n_embd
        self.c_fc = nn.Linear(C, 4 * C, bias=config.bias,
                              dtype=config.param_dtype)
        self.c_proj = nn.Linear(4 * C, C, bias=config.bias,
                                dtype=config.param_dtype)

    def forward(self, x, drop=None):
        lay = self.layout
        split = "c_proj.weight" in self.split  # c_fc's columns with it
        if split:  # column-parallel c_fc, row-parallel c_proj
            x = copy_to(x, lay.model_group)
        # Flax's nn.gelu is the tanh approximation
        h = F.gelu(_linear(x, self.c_fc), approximate="tanh")
        if split:
            y = reduce_from(
                F.linear(h, cast_param(self.c_proj.weight, h.dtype)),
                lay.model_group)
            if self.c_proj.bias is not None:
                y = y + cast_param(self.c_proj.bias, y.dtype)
        else:
            y = _linear(h, self.c_proj)
        if drop is not None:
            y = dropout(y, *drop, SITE_MLP_OUT, lay)
        return y


class Block(nn.Module):
    """Pre-LN transformer block. With ``config.n_expert > 0`` the MLP is
    the routed ``moe`` (``models/moe.py``) and ``forward`` returns
    ``(x, aux)``, else ``x``: the arity is fixed by the config, as in JAX
    (gpt.py:818-848), so the dense callers (TunesFormer) are unchanged.
    ``aux=False`` skips the load-balance term (aux None) where no loss
    reads it; JAX's jit drops that dead value, the eager port must not
    launch it."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        C = config.n_embd
        self.config = config
        self.ln_1 = nn.LayerNorm(C, eps=1e-5, bias=config.bias,
                                 dtype=config.param_dtype)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = nn.LayerNorm(C, eps=1e-5, bias=config.bias,
                                 dtype=config.param_dtype)
        if config.n_expert > 0:
            from ai_music_generation_tpu_torch.models.moe import MoEMLP

            self.moe = MoEMLP(config)
        else:
            self.mlp = MLP(config)

    def forward(self, x, layer_cache=None, cache_len=None, cursor=None,
                spec_col_pos=None, mask_rel=None, drop=None, aux=True):
        with tracing.span(tracing.GPT_BLOCK):
            x = x + self.attn(_layer_norm(x, self.ln_1), layer_cache,
                              cache_len, cursor, spec_col_pos, mask_rel, drop)
            if self.config.n_expert > 0:
                y, aux = self.moe(_layer_norm(x, self.ln_2), drop, aux)
                return x + y, aux
            return x + self.mlp(_layer_norm(x, self.ln_2), drop)


class GPT(nn.Module):
    """Decoder-only LM with a weight-tied head.

    ``forward(idx, targets=None, cache=None, return_all_logits=False,
    dropout_key=None)`` returns two values, as nanoGPT's ``model.py``:

    - without ``targets``, ``(logits, cache)``: logits in the compute dtype
      for the last position (or all positions with ``return_all_logits``);
      with a cache, the new tokens are written at ``cache.length``
      (speculative and ring mode: at ``cache.cursor``, see
      :class:`KVCache`) and the same cache, updated in place, is returned;
    - with ``targets`` [B, T] (no cache), ``(logits, loss)``: logits for
      every position and the fp32 mean cross-entropy over the targets that
      are not -1 (:func:`cross_entropy_ignore_index`).

    In ``train()`` mode with ``config.dropout > 0`` the no-cache forward
    drops at the JAX model's four sites with the masks of
    ``dropout_key`` (:func:`dropout_key`; required then); in ``eval()``
    mode, and on every cached call, nothing is dropped.

    Weights: load a state dict (``models.convert.state_dict_from_jax``) or
    call ``models.convert.init_weights``; the constructor leaves torch's
    default initialisation. ``device`` None creates the parameters on the
    card, as ``KVCache.create`` allocates, and raises when there is none;
    pass ``device="cpu"`` for a CPU model.
    """

    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
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

    def forward(self, idx: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                return_all_logits: bool = False,
                dropout_key: Optional[int] = None):
        if tracing.recording():
            GPT.forward.calls += 1
        with tracing.span(tracing.GPT_FORWARD):
            return self._forward(idx, targets, cache, return_all_logits,
                                 dropout_key)

    def _forward(self, idx, targets, cache, return_all_logits, dropout_key):
        cfg = self.config
        B, T = idx.shape
        if T > cfg.block_size:
            raise ValueError(
                f"sequence length {T} exceeds block_size {cfg.block_size}")
        if targets is not None and cache is not None:
            raise ValueError("targets take the no-cache forward")
        lay = self.layout
        if cfg.seq_axis is not None:
            if cache is not None:
                raise NotImplementedError(
                    "seq_axis is a training-path knob; decode stays on the "
                    "data/model axes (parallel/sequence.py docstring)")
            if self.training and cfg.dropout > 0:
                raise NotImplementedError(
                    "attention-prob dropout is not expressible under ring "
                    "attention; train sequence-parallel with dropout=0")
            if lay is None or lay.seq_group is None:
                raise ValueError(
                    f"seq_axis={cfg.seq_axis!r} needs a layout with a seq "
                    "axis (parallel/sequence.py)")
        drop = None
        if self.training and cfg.dropout > 0 and cache is None:
            if dropout_key is None:
                raise ValueError(
                    "dropout is active in train() mode: pass dropout_key "
                    "(models.gpt.dropout_key), or call eval()")
            drop = (cfg.dropout, dropout_key)
        wte = cast_param(self.transformer.wte.weight, cfg.dtype)
        pos = torch.arange(T, device=idx.device)
        spec_col_pos = mask_rel = None
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
        elif cache is not None and cache.cursor is not None:
            pos, mask_rel = ring_positions(cache, T, cfg.block_size)
        elif cache is not None:
            pos = pos + cache.length
        elif cfg.seq_axis is not None:
            # local row t is global position seq_rank * T + t (the caller,
            # parallel/sequence.py, holds the global T to block_size)
            pos = pos + lay.seq_rank * T
        vocab_split = "transformer.wte.weight" in self.split
        tok = (vocab_embedding(idx, wte, lay) if vocab_split
               else F.embedding(idx, wte))
        x = tok + F.embedding(
            pos, cast_param(self.transformer.wpe.weight, cfg.dtype))
        if drop is not None:
            x = dropout(x, *drop, 0, SITE_EMBED, lay)
        # remat (JAX gpt.py:945-948): each block's activations are
        # recomputed in the backward pass; the masks are counter hashes, so
        # no RNG state needs restoring, and an MoE block's routing is a
        # function of its input, so the recompute routes as it did
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        # only the loss reads the MoE aux (targets never come with a cache)
        need_aux = targets is not None
        aux_total = None
        for i, block in enumerate(self.transformer.h):
            if cache is None:
                layer_drop = None if drop is None else (*drop, i)
                if remat:
                    out = checkpoint(block, x, drop=layer_drop, aux=need_aux,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
                else:
                    out = block(x, drop=layer_drop, aux=need_aux)
            else:
                layer_cache = (
                    cache.k[i], cache.v[i],
                    None if cache.k_scale is None else cache.k_scale[i],
                    None if cache.v_scale is None else cache.v_scale[i])
                out = block(x, layer_cache, cache.length, cache.cursor,
                            spec_col_pos, mask_rel, aux=False)
            if cfg.n_expert > 0:
                x, aux = out
                if need_aux:
                    aux_total = aux if aux_total is None else aux_total + aux
            else:
                x = out
        x = _layer_norm(x, self.transformer.ln_f)
        if targets is not None:
            if vocab_split:  # this rank's vocab slice of the logits
                x = copy_to(x, lay.model_group)
            logits = F.linear(x, wte)  # weight tying
            loss = cross_entropy_ignore_index(logits, targets, layout=lay,
                                              vocab_split=vocab_split)
            if cfg.n_expert > 0:
                # the aux averaged over layers, so moe_aux_coef does not
                # depend on the depth (JAX gpt.py:1004-1007)
                loss = loss + cfg.moe_aux_coef * aux_total / cfg.n_layer
            return logits, loss
        if spec_col_pos is not None:
            # JAX gpt.py:981-998: the cursor advances by the 8-aligned
            # write width, the length as if every token were accepted
            cache.col_pos = spec_col_pos
            cache.cursor += -(-T // 8) * 8
            cache.length += T
        elif cache is not None:
            advance(cache, T)
        if not return_all_logits:
            x = x[:, -1:]  # inference fast path: last position only
        logits = F.linear(x, wte)
        if vocab_split:  # sampling reads every vocabulary entry
            logits = gather_last(logits, lay.model_group, sum_grad=False)
        return logits, cache

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


GPT.forward.calls = 0


def cross_entropy_ignore_index(logits: torch.Tensor, targets: torch.Tensor,
                               ignore_index: int = -1, layout=None,
                               vocab_split: bool = False) -> torch.Tensor:
    """Mean token cross-entropy over the targets that are not
    ``ignore_index`` (JAX gpt.py:1019-1050): ``logsumexp - logit[target]``
    in fp32 (the logits are upcast here, not before the head), masked,
    divided by ``max(count, 1)``, so a batch whose every target is ignored
    gives 0 (``F.cross_entropy(..., ignore_index=-1)`` gives nan there).

    On a mesh (``layout``): with ``vocab_split`` the logits are this rank's
    vocab slice (rank r holds ``[r*V_local, (r+1)*V_local)``), and the
    logsumexp and the target's logit are summed over the model axis; the
    rows are this rank's of the data axis, and the result is its share of
    the global mean (its sum over the global count, times the data-axis
    size), so the data-axis mean of the ranks' values, and of their
    gradients, is the global mean's. On a layout with a seq axis (JAX's
    ``axis_name=(seq, data)``) the count is summed over the seq and data
    groups and the result is the rank's sum over it: the sum of the ranks'
    values, and of their gradients, over the mesh is the global mean's."""
    logits = logits.float()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, 0).long()
    if vocab_split:
        group, V = layout.model_group, logits.shape[-1]
        top = all_reduce_(logits.detach().amax(-1), group,
                          torch.distributed.ReduceOp.MAX)
        lse = top + reduce_from((logits - top[..., None]).exp().sum(-1),
                                group).log()
        local = safe - layout.model_rank * V
        inside = (local >= 0) & (local < V)
        tgt = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
        tgt = reduce_from(torch.where(inside, tgt, 0.0), group)
        nll = lse - tgt
    else:
        tgt = logits.gather(-1, safe[..., None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - tgt
    count = mask.sum()
    if layout is not None and layout.seq_group is not None:
        all_reduce_(count, layout.seq_group)
        if layout.data_group is not None:
            all_reduce_(count, layout.data_group)
        return (nll * mask).sum() / count.clamp_min(1)
    if layout is None or layout.n_data == 1:
        return (nll * mask).sum() / count.clamp_min(1)
    count = all_reduce_(count, layout.data_group)
    return (nll * mask).sum() / count.clamp_min(1) * layout.n_data


# dense bf16 peak per card for MFU, by a substring of its CUDA name (the
# same peak whatever the compute dtype, as the JAX table): NVIDIA's H100
# data sheet; the CPU's is the JAX table's nominal 1 TFLOP/s
PEAK_FLOPS = {"h100": 989e12}
CPU_PEAK_FLOPS = 1e12


def peak_flops_for(device=None) -> float:
    """Peak FLOP/s of ``device`` (default: the card, else the CPU) for MFU
    accounting (JAX gpt.py:1081-1086): the table entry whose key is in
    ``torch.cuda.get_device_name``; a card that is not in the table
    raises."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_PEAK_FLOPS
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_FLOPS.items():
        if key in name.lower():
            return peak
    raise ValueError(f"no peak FLOP/s is known for {name!r}: add it to "
                     "models.gpt.PEAK_FLOPS")


def estimate_mfu(config: GPTConfig, n_params: int, fwdbwd_per_iter: float,
                 dt: float, peak_flops: Optional[float] = None) -> float:
    """PaLM-appendix-B MFU estimate (JAX gpt.py:1089-1095): ``n_params``
    without the position table (``GPT.num_params()``), ``fwdbwd_per_iter``
    sequences of block_size tokens per iteration of ``dt`` seconds. As in
    JAX, an MoE model's every expert counts, though a token runs only
    ``expert_top_k`` of them: its MFU is inflated."""
    L, H, Q, T = (config.n_layer, config.n_head, config.head_dim,
                  config.block_size)
    flops_per_token = 6 * n_params + 12 * L * H * Q * T
    flops_per_iter = flops_per_token * T * fwdbwd_per_iter
    return (flops_per_iter / dt) / (peak_flops or peak_flops_for())
