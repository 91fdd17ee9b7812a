"""TunesFormer, the hierarchical dual decoder over bar patches, in PyTorch:
the port of ``ai_music_generation_tpu/models/tunesformer.py``.

- :class:`PatchEmbedding`: the reference's one-hot(128) -> flatten ->
  Linear, computed as the algebraically identical gather-sum of table rows
  at ``char + 128 * position`` (in the compute dtype, plus the bias);
- :class:`TransformerCore`: a GPT-2 stack over given input embeddings
  (``wpe`` + the port's :class:`~.gpt.Block` s + ``ln_f``), with or without
  a :class:`~.gpt.KVCache`, lockstep or ring mode (``per_row=True``, the
  server's patch cache), as the JAX core reuses the JAX GPT's ``Block``
  over its ``KVCache``;
- :class:`TunesFormer`: the patch core over patch embeddings, the char core
  over chars within a bar whose position-0 embedding is the encoded patch,
  a char head tied to ``char_wte``; ``share_weights`` shares one core.

Every cached T=1 step (``patch_step``, ``char_step``) runs the port's K1
(``ops/gqa_decode.py``) once per layer on the card; a prefill
(``encode_patches_cached``) and the no-cache forwards run plain torch ops,
as the JAX package runs them as XLA einsums. Numerics follow the Flax
modules as ``models/gpt.py`` does: fp32 parameters cast to the compute
dtype at each use.

Training (``train/tunes_step.py``): in ``train()`` mode with
``dropout > 0`` the loss forward drops where the JAX model drops (each
core's embedding sum, and in every block the attention probabilities, the
attention output and the MLP output) with the port's counter-hash masks
(``models/gpt.py::dropout``). The caller passes one key a step; each core
drops with its own key, :func:`core_dropout_key` of the step key and the
core's tag, so the patch and the char core never share mask bits (with
``share_weights`` the one core runs twice, under the two keys).

On a (data, model) mesh (``train/tunes_step.py::shard_tunesformer_step``
sets each split module's ``layout``) the loss forward runs this rank's
part, as ``models/gpt.py`` does: the patch embedding's table is split on
n_embd (JAX's column-parallel rule) and its slabs are gathered over the
model axis, both cores run tensor parallel, ``char_wte`` is split on the
vocab with the tied head's cross-entropy over the vocab shards, and the
masks index each site by global coordinates. The cached steps run the
same parts for the sharded server (``serve/tunes_engine.py``), the char
step gathering its logits over the vocab shards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ai_music_generation_tpu_torch.models.gpt import (
    SITE_EMBED,
    Block,
    GPTConfig,
    KVCache,
    _layer_norm,
    advance,
    cross_entropy_ignore_index,
    dropout,
    ring_positions,
    vocab_embedding,
)
from ai_music_generation_tpu_torch.parallel.collectives import (
    copy_to,
    gather_last,
)
from ai_music_generation_tpu_torch.utils.hash32 import mix32, mul32

CHAR_VOCAB = 128  # ASCII
# the cores' tags in their dropout keys (core_dropout_key)
PATCH_CORE, CHAR_CORE = 1, 2


def core_dropout_key(key: int, core: int) -> int:
    """The dropout key of one core (``PATCH_CORE`` or ``CHAR_CORE``) in the
    step of ``key``: a hash of the two, so the cores' masks are unrelated
    even at sites of the same shape (both have a layer 0)."""
    return mix32(key ^ mul32(core, 0x27D4EB2F))


@dataclasses.dataclass(frozen=True)
class TunesFormerConfig:
    """The JAX ``TunesFormerConfig``'s fields and defaults (the reference
    model: 9 patch layers, 3 char layers, 768 wide, 12 heads, 128 patches
    of 32 chars); ``dtype`` and ``param_dtype`` are torch dtypes.
    ``dropout`` acts in the loss forward in ``train()`` mode."""

    patch_length: int = 128
    patch_size: int = 32
    patch_layers: int = 9
    char_layers: int = 3
    n_embd: int = 768
    n_head: int = 12
    dropout: float = 0.1
    share_weights: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def _core(self, layers: int, block: int, vocab: int) -> GPTConfig:
        if self.share_weights:
            layers = max(self.patch_layers, self.char_layers)
            block = max(self.patch_length, self.patch_size)
        return GPTConfig(
            block_size=block, vocab_size=vocab, n_layer=layers,
            n_head=self.n_head, n_embd=self.n_embd, dropout=self.dropout,
            bias=True, dtype=self.dtype, param_dtype=self.param_dtype)

    def patch_core_config(self) -> GPTConfig:
        return self._core(self.patch_layers, self.patch_length, 1)

    def char_core_config(self) -> GPTConfig:
        return self._core(self.char_layers, self.patch_size, CHAR_VOCAB)


class TransformerCore(nn.Module):
    """GPT-2 stack over pre-computed input embeddings (``wpe`` + blocks +
    ``ln_f``). ``forward(embeds [B, T, C], cache=None, drop=None)`` returns
    (hidden [B, T, C] in the compute dtype, cache); a cache is updated in
    place at ``cache.length`` (lockstep) or at its cursor (ring mode, T=1,
    positions clipped as JAX's gather clips: ``models.gpt.ring_positions``).
    ``drop`` = (p, the core's key) drops at the embedding sum and at each
    block's three sites (no-cache forward only), as GPT.forward does."""

    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C, dt = config.n_embd, config.param_dtype
        self.wpe = nn.Embedding(config.block_size, C, dtype=dt)
        self.h = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(C, eps=1e-5, bias=config.bias, dtype=dt)

    def forward(self, embeds: torch.Tensor,
                cache: Optional[KVCache] = None, drop=None):
        cfg = self.config
        B, T, _ = embeds.shape
        if T > cfg.block_size:
            raise ValueError(
                f"sequence length {T} exceeds block_size {cfg.block_size}")
        mask_rel = None
        if cache is not None and cache.cursor is not None:
            pos, mask_rel = ring_positions(cache, T, cfg.block_size)
        else:
            pos = torch.arange(T, device=embeds.device)
            if cache is not None:
                pos = pos + cache.length
            pos = pos[None]
        x = embeds.to(cfg.dtype) + F.embedding(
            pos, self.wpe.weight.to(cfg.dtype))
        if drop is not None and cache is None:
            x = dropout(x, *drop, 0, SITE_EMBED, self.layout)
        for i, block in enumerate(self.h):
            if cache is None:
                x = block(x, drop=None if drop is None else (*drop, i))
                continue
            layer_cache = (
                cache.k[i], cache.v[i],
                None if cache.k_scale is None else cache.k_scale[i],
                None if cache.v_scale is None else cache.v_scale[i])
            x = block(x, layer_cache, cache.length, cache.cursor, None,
                      mask_rel)
        x = _layer_norm(x, self.ln_f)
        if cache is not None:
            advance(cache, T)
        return x, cache


class PatchEmbedding(nn.Module):
    """one-hot(128) -> flatten -> Linear as a gather-sum: ``weight`` is the
    [patch_size * 128, n_embd] table (the reference Linear's weight
    transposed), ``bias`` [n_embd]. [B, P, S] int -> [B, P, n_embd] in the
    compute dtype: the S rows at ``patches + 128 * arange(S)``, cast to the
    compute dtype, summed, plus the bias (JAX tunesformer.py:134-150).
    On a mesh the table and the bias are this rank's n_embd columns."""

    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config: TunesFormerConfig):
        super().__init__()
        self.config = config
        dt = config.param_dtype
        self.weight = nn.Parameter(torch.empty(
            config.patch_size * CHAR_VOCAB, config.n_embd, dtype=dt))
        nn.init.normal_(self.weight, 0.0, 0.02)  # the JAX init's scale
        self.bias = nn.Parameter(torch.zeros(config.n_embd, dtype=dt))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        offs = torch.arange(cfg.patch_size, device=patches.device) * CHAR_VOCAB
        rows = F.embedding(patches.long() + offs, self.weight.to(cfg.dtype))
        out = rows.sum(dim=2) + self.bias.to(cfg.dtype)
        if "weight" in self.split:  # gather the columns
            out = gather_last(out, self.layout.model_group, sum_grad=False)
        return out


class TunesFormer(nn.Module):
    """The dual decoder. ``forward(patches, patch_indices=None,
    dropout_key=None)`` is the training loss: in ``train()`` mode with
    ``config.dropout > 0`` it needs ``dropout_key`` (a step's key, e.g.
    ``models.gpt.dropout_key(seed, step)``) and drops with each core's
    :func:`core_dropout_key`; in ``eval()`` mode it drops nothing. The
    generation entry points are
    :meth:`encode_patches`, :meth:`encode_patches_cached`,
    :meth:`patch_step`, :meth:`char_logits` and :meth:`char_step`.

    Weights: load a state dict (``models.convert.
    tunesformer_state_dict_from_jax``, ``models.tunesformer_import``) or call
    ``models.convert.init_tunesformer_weights``. ``layout`` (on a mesh):
    see the module docstring. ``device`` None creates the
    parameters on the card and raises when there is none; pass
    ``device="cpu"`` for a CPU model. With ``share_weights`` one core
    (``core``) serves both levels, as JAX tunesformer.py:164-168."""

    layout, split = None, frozenset()

    def __init__(self, config: TunesFormerConfig, device=None):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TunesFormer creates its parameters on the CUDA device by "
                    'default and none is available; pass device="cpu" for a '
                    "CPU model")
            device = torch.device("cuda")
        self.config = config
        with torch.device(device):
            self.patch_embedding = PatchEmbedding(config)
            self.char_wte = nn.Embedding(CHAR_VOCAB, config.n_embd,
                                         dtype=config.param_dtype)
            if config.share_weights:
                # one registered module (state dict keys ``core.*``); the two
                # names are plain attributes that point at it
                self.core = TransformerCore(config.patch_core_config())
                object.__setattr__(self, "patch_core", self.core)
                object.__setattr__(self, "char_core", self.core)
            else:
                self.patch_core = TransformerCore(config.patch_core_config())
                self.char_core = TransformerCore(config.char_core_config())

    @property
    def device(self) -> torch.device:
        return self.char_wte.weight.device

    def _wte(self) -> torch.Tensor:
        return self.char_wte.weight.to(self.config.dtype)

    def encode_patches(self, patches: torch.Tensor,
                       drop=None) -> torch.Tensor:
        """[B, P, S] int -> [B, P, n_embd] encoded patch states (``drop``:
        the patch core's (p, key), see TransformerCore)."""
        return self.patch_core(self.patch_embedding(patches), drop=drop)[0]

    def encode_patches_cached(self, patches: torch.Tensor, cache: KVCache):
        """``encode_patches`` that also fills a lockstep patch-core cache at
        its length (the prefill of incremental patch decoding). Returns
        (hidden [B, P, C], the cache, its length advanced by P)."""
        return self.patch_core(self.patch_embedding(patches), cache)

    def patch_step(self, new_patch: torch.Tensor, cache: KVCache):
        """One cached patch-core position: ``new_patch`` [B, S] (the
        just-committed bar) through the core against ``cache`` (lockstep or
        ring). Returns (hidden [B, C], the encoding that conditions the next
        bar's chars; the cache)."""
        hidden, cache = self.patch_core(
            self.patch_embedding(new_patch[:, None, :]), cache)
        return hidden[:, 0, :], cache

    def char_logits(self, encoded_patch: torch.Tensor,
                    tokens: torch.Tensor, drop=None) -> torch.Tensor:
        """[N, C] encoded patches and [N, S] chars -> [N, S, 128] logits:
        position 0's embedding is the encoded patch, the head is tied to
        ``char_wte`` (``drop``: the char core's (p, key))."""
        wte = self._wte()
        if self._vocab_split():  # this rank's vocab slice of the logits
            tok = vocab_embedding(tokens, wte, self.layout)
        else:
            tok = F.embedding(tokens.long(), wte)
        embeds = torch.cat([encoded_patch[:, None, :].to(wte.dtype),
                            tok[:, 1:, :]], dim=1)
        hidden, _ = self.char_core(embeds, drop=drop)
        if self._vocab_split():
            hidden = copy_to(hidden, self.layout.model_group)
        return F.linear(hidden, wte)

    def _vocab_split(self) -> bool:
        return "char_wte.weight" in self.split

    def char_step(self, encoded_patch: torch.Tensor, tok: torch.Tensor,
                  cache: KVCache):
        """One cached char-core position (lockstep cache, ``max_len >=
        patch_size``): the encoded patch [N, C] when ``cache.length`` is 0
        (selected on the device: no host sync), else the embedding of
        ``tok`` [N]. Returns (logits [N, 128], the cache)."""
        wte = self._wte()
        if self._vocab_split():
            tok_emb = vocab_embedding(tok[:, None], wte, self.layout)
        else:
            tok_emb = F.embedding(tok.long(), wte)[:, None, :]
        embeds = torch.where(cache.length == 0,
                             encoded_patch[:, None, :].to(wte.dtype), tok_emb)
        hidden, cache = self.char_core(embeds, cache)
        logits = F.linear(hidden[:, 0, :], wte)
        if self._vocab_split():  # sampling reads every char
            logits = gather_last(logits, self.layout.model_group,
                                 sum_grad=False)
        return logits, cache

    def forward(self, patches: torch.Tensor,
                patch_indices: Optional[torch.Tensor] = None,
                dropout_key: Optional[int] = None) -> torch.Tensor:
        """Mean char cross-entropy (JAX tunesformer.py:243-272): encoded
        patch p conditions the chars of patch p+1; pad chars (0) are
        ignored; ``patch_indices`` [B, K] selects the conditioning rows
        (0..P-2) that feed the char decoder. Dropout: see the class."""
        cfg = self.config
        drops = (None, None)
        if self.training and cfg.dropout > 0:
            if dropout_key is None:
                raise ValueError(
                    "dropout is active in train() mode: pass dropout_key "
                    "(models.gpt.dropout_key), or call eval()")
            drops = tuple((cfg.dropout, core_dropout_key(dropout_key, core))
                          for core in (PATCH_CORE, CHAR_CORE))
        B, P, S = patches.shape
        C = cfg.n_embd
        encoded = self.encode_patches(patches, drops[0])
        cond, target = encoded[:, :-1, :], patches[:, 1:, :]
        if patch_indices is not None:
            idx = patch_indices.long()
            cond = torch.gather(cond, 1, idx[:, :, None].expand(-1, -1, C))
            target = torch.gather(target, 1,
                                  idx[:, :, None].expand(-1, -1, S))
        cond, target = cond.reshape(-1, C), target.reshape(-1, S)
        logits = self.char_logits(cond, target, drops[1])
        labels = torch.where(target == 0, -1, target)
        return cross_entropy_ignore_index(
            logits[:, :-1, :], labels[:, 1:], layout=self.layout,
            vocab_split=self._vocab_split())


def load_tunesformer(out_dir: str, dtype: torch.dtype = torch.bfloat16,
                     device=None, name: str = "weights"):
    """(model in eval mode, meta) from ``out_dir/weights.pth``, a reference
    TunesFormer checkpoint (written by the reference's train.py or by
    ``models.tunesformer_export.save_reference_checkpoint``); the
    architecture is read from the tensors' shapes
    (``config_from_reference_state``: patch_length and n_head are the
    file's ``model_args`` where the port wrote them, else the reference's
    defaults). An orbax checkpoint (``out_dir/<name>``, the JAX
    package's format) cannot be read here: convert it with the JAX package's
    ``convert_ckpt tunesformer to-torch`` first."""
    from ai_music_generation_tpu_torch.models.tunesformer_import import (
        config_from_reference_state, port_state_from_reference,
        read_reference,
    )

    path = os.path.join(out_dir, "weights.pth")
    if not os.path.exists(path):
        if os.path.exists(os.path.join(out_dir, name)):
            raise FileNotFoundError(
                f"{out_dir}/{name} is an orbax checkpoint (the JAX package's "
                f"format) and {path} does not exist: convert it with `python "
                f"-m ai_music_generation_tpu.cli.convert_ckpt tunesformer "
                f"to-torch --out_dir {out_dir} --out {path}` first")
        raise FileNotFoundError(f"no TunesFormer checkpoint at {path}")
    ckpt, state = read_reference(path)
    known = {k: v for k, v in ckpt.get("model_args", {}).items()
             if k in ("patch_length", "n_head")}
    cfg = dataclasses.replace(
        config_from_reference_state(state, dtype=dtype, **known),
        dropout=0.0)
    model = TunesFormer(cfg, device=device)
    model.load_state_dict(port_state_from_reference(state, cfg))
    meta = {
        "model_args": dict(
            patch_length=cfg.patch_length, patch_size=cfg.patch_size,
            patch_layers=cfg.patch_layers, char_layers=cfg.char_layers,
            n_embd=cfg.n_embd, n_head=cfg.n_head,
            share_weights=cfg.share_weights),
        "iter_num": int(ckpt.get("epoch", 0)),
        "best_val_loss": float(ckpt.get("min_eval_loss", 100.0)),
        "config": {},
    }
    return model.eval(), meta
