"""TunesFormer two-level generation, batched: the port of
``ai_music_generation_tpu/decode/tunes_generate.py``.

Bars for every tune of a batch are generated lockstep. A generate prefills
the patch-core cache from the prompt once (one [B, L, S] forward), then
each bar is one cached patch position (``TunesFormer.patch_step``, the
newest committed patch) and a scan of the char decoder over the S in-bar
positions (:func:`char_bar_scan`, one ``char_step`` a position) with
sampling on the device; the host keeps the per-bar string bookkeeping
(patch re-encoding, control-code filtering, stop rules) and sees the
device once a bar: one upload of the bar's inputs, one download of its
chars. On the card every cached step runs K1 (``ops/gqa_decode.py``) once
per layer: ``patch_layers + patch_size * char_layers`` launches a bar.

Sampling is the reference chain nucleus (top-p) -> top-k -> temperature
(p^(1/T), renormalized) over the sorted probabilities, as JAX's
:func:`sample_top_p_top_k_temperature`; ties sort toward the lower index,
as ``jax.lax.top_k``. JAX draws from threefry streams, which torch cannot
reproduce: the port draws with an explicit ``torch.Generator`` re-seeded
for each (seed, bar, sampled-char index) by :func:`fold_seed`, so a tune
depends only on its seed and the batch's settings (on one device: the CPU's
and the card's generators give other numbers).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ai_music_generation_tpu_torch.models.gpt import KVCache
from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.tokenizers.patchilizer import (
    Patchilizer,
    _ascii,
)
from ai_music_generation_tpu_torch.utils.hash32 import GOLDEN, M32, mix32, mul32

# (probs [B, V] fp32, position j in the bar) -> [B] int32 sampled chars
SampleFn = Callable[[torch.Tensor, int], torch.Tensor]


def filter_sorted(probs: torch.Tensor, top_p, top_k, inv_temperature=None):
    """The reference chain up to its draw: (filtered [B, V], sorted_idx
    [B, V]), both in descending-probability order (stable: ties toward the
    lower index). The nucleus keeps the ranks whose preceding cumulative
    mass is < ``top_p`` (rank 0 always), top-k the ranks < ``top_k``; the
    kept probabilities are raised to ``inv_temperature`` (p^(1/T)) when it
    is given, the rest are 0. ``top_p``, ``top_k`` and ``inv_temperature``
    are numbers or [B, 1] tensors. Unnormalized: a draw proportional to
    ``filtered`` is the reference's renormalized draw."""
    V = probs.shape[-1]
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                          stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < top_p
    keep[..., 0] = True
    keep &= torch.arange(V, device=probs.device) < top_k
    filtered = torch.where(keep, sorted_probs, 0.0)
    if inv_temperature is not None:
        filtered = torch.where(filtered > 0, filtered.pow(inv_temperature),
                               0.0)
    return filtered, sorted_idx


def draw(filtered: torch.Tensor, sorted_idx: torch.Tensor,
         noise: torch.Tensor) -> torch.Tensor:
    """One index per row with probability proportional to ``filtered``
    (an exponential race: argmax of filtered / E, E ~ Exp(1) in ``noise``,
    kept above 0), mapped back through ``sorted_idx``. [B] int32."""
    choice = (filtered / noise.clamp_min(torch.finfo(noise.dtype).tiny)
              ).argmax(dim=-1)
    return sorted_idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)


def sample_top_p_top_k_temperature(probs: torch.Tensor,
                                   generator: torch.Generator,
                                   top_p: float = 1.0, top_k: int = 0,
                                   temperature: float = 1.0) -> torch.Tensor:
    """Chained nucleus -> top-k -> temperature sampling with one setting for
    the batch (``top_k <= 0``: no top-k; temperature 1: no reshape); the
    draw's noise comes from ``generator`` (on probs' device). [B] int32."""
    V = probs.shape[-1]
    filtered, sorted_idx = filter_sorted(
        probs, top_p, top_k if top_k and top_k > 0 else V,
        None if temperature == 1.0 else 1.0 / temperature)
    noise = torch.empty_like(filtered).exponential_(generator=generator)
    return draw(filtered, sorted_idx, noise)


def fold_seed(seed: int, bar: int, idx: int) -> int:
    """The generator seed of sampled char ``idx`` of bar ``bar`` under the
    generate's ``seed`` (the port's ``fold_in(fold_in(key, bar), idx)``):
    murmur3 finalizers (``utils/hash32.py``) over the three."""
    h = mix32(mix32((seed & M32) ^ 0x243F6A88) ^ (bar & M32))
    return mix32(h ^ mul32(idx & M32, GOLDEN))


def filter_control_codes(text: str, show_control_code: bool) -> str:
    """Hide S:/B:/E: lines of a prompt from visible output (they still
    condition the model). Shared by the batch generator and the server."""
    if show_control_code:
        return text
    return "".join(
        line for line in text.splitlines(keepends=True)
        if line[:2] not in ("S:", "B:", "E:"))


def filter_generated_bar(bar: str, show_control_code: bool) -> str:
    """Hide a generated bar iff its first two chars are a control code (the
    reference's rule on the whole bar, unlike the per-line prompt filter:
    a multi-line bar whose first line is ``S:`` is hidden entirely)."""
    if show_control_code:
        return bar
    return "" if bar[:2] in ("S:", "B:", "E:") else bar


def prepare_patch_state(patchilizer: Patchilizer, prompt: str, L: int,
                        S: int):
    """Patch-encode a prompt; returns (prompt_patches, carried_chars).

    The trailing special eos patch is dropped so generation continues the
    tune (when the prompt fills all L patches, encode()'s truncation has
    already removed it, and the prompt's last real bar stays). ``carried``
    is the prompt tail past the last patch boundary, which seeds the first
    generated bar; it is only taken when the decoded patches are a string
    prefix of the (ASCII-folded) prompt, else carrying would duplicate text
    already encoded."""
    prompt_patches = patchilizer.encode(prompt, L, S,
                                        add_special_patches=True)
    eos_patch = ([Patchilizer.bos_token_id]
                 + [Patchilizer.eos_token_id] * (S - 1))
    if prompt_patches and list(prompt_patches[-1]) == eos_patch:
        prompt_patches = prompt_patches[:-1]
    prefix = patchilizer.decode(prompt_patches)
    norm = _ascii(prompt)
    carried = norm[len(prefix):] if norm.startswith(prefix) else ""
    return prompt_patches, carried


def char_bar_scan(model: TunesFormer, last: torch.Tensor,
                  init_tokens: torch.Tensor, init_lens: torch.Tensor,
                  sample_fn: SampleFn, cache: Optional[KVCache] = None):
    """Decode one bar's chars for each row, given its conditioning vector.

    last:        [B, C] encoded-patch conditioning (position 0's embedding
                 in the char decoder)
    init_tokens: [B, S] int32 (bos + any carried partial-bar chars)
    init_lens:   [B] int32, the valid init tokens (>= 1)
    sample_fn:   (probs [B, 128], j) -> [B] int32 chars
    cache:       a lockstep char-core cache of B rows and >= S columns to
                 reuse (its length is reset); None allocates one
    Returns (tokens [B, S] with the init prefix and the sampled chars, lens
    [B]).

    Position-lockstep KV-cached decode over the S positions, all on the
    device: position j's input is the init token while j < init_lens[row],
    else the char sampled from position j-1's logits; a row stops writing
    after an eos or when full."""
    B, S = init_tokens.shape
    if cache is None:
        cache = KVCache.create(model.config.char_core_config(), B,
                               max_len=S, device=last.device)
    else:
        cache.length.zero_()
    tokens = init_tokens.clone()
    lens = init_lens.clone()
    finished = torch.zeros(B, dtype=torch.bool, device=last.device)
    logits = torch.zeros(B, model.char_wte.num_embeddings,
                         dtype=torch.float32, device=last.device)
    for j in range(S):
        probs = torch.softmax(logits, dim=-1)
        sampled = sample_fn(probs, j)
        in_init = j < init_lens
        can_write = ~finished & ~in_init
        col = torch.where(in_init, init_tokens[:, j],
                          torch.where(can_write, sampled, tokens[:, j]))
        tokens[:, j] = col
        lens = lens + can_write.to(lens.dtype)
        finished = (finished | (can_write & (sampled == Patchilizer.eos_token_id))
                    | (lens >= S))
        step_logits, _ = model.char_step(last, col, cache)
        logits = step_logits.float()
    return tokens, lens


def bar_scan(model: TunesFormer, patches: torch.Tensor,
             n_patches: torch.Tensor, init_tokens: torch.Tensor,
             init_lens: torch.Tensor, sample_fn: SampleFn):
    """One bar for each row, conditioned by a FULL patch-core forward over
    the whole padded patch stack [B, L, S] (``n_patches`` [B] valid, >= 1):
    the reference's per-bar re-encode, kept as the exactness oracle of the
    cached path (``patch_step`` + :func:`char_bar_scan`)."""
    encoded = model.encode_patches(patches)
    rows = torch.arange(patches.shape[0], device=patches.device)
    last = encoded[rows, n_patches.long() - 1]
    return char_bar_scan(model, last, init_tokens, init_lens, sample_fn)


class TunesGenerator:
    """Batched bar-by-bar generator over a :class:`TunesFormer` (its weights
    and device are the model's) with one sampling setting."""

    def __init__(self, model: TunesFormer, top_p: float = 0.8,
                 top_k: int = 8, temperature: float = 1.2):
        self.model = model
        self.cfg = model.config
        self.top_p = top_p
        self.top_k = top_k
        self.temperature = temperature
        self.patchilizer = Patchilizer()

    def _prefill(self, patches: torch.Tensor, n0: int) -> KVCache:
        """Fill the patch-core cache from the prompt patches [B, L, S] with
        one forward, then rewind its length to ``n0 - 1``, so the first bar
        re-feeds the prompt's last patch and every bar runs the same
        one-position step (the column at n0-1 is rewritten with the same
        K/V)."""
        cache = KVCache.create(self.cfg.patch_core_config(),
                               patches.shape[0], max_len=patches.shape[1],
                               device=patches.device)
        self.model.encode_patches_cached(patches, cache)
        cache.length.fill_(n0 - 1)
        return cache

    def _bar_step(self, cache: KVCache, new_patch: torch.Tensor,
                  init_tokens: torch.Tensor, init_lens: torch.Tensor,
                  sample_fn: SampleFn, char_cache: KVCache):
        """One cached patch position (the just-committed patch [B, S]) and
        the char bar scan. Returns (tokens [B, S], lens [B])."""
        last, _ = self.model.patch_step(new_patch, cache)
        return char_bar_scan(self.model, last, init_tokens, init_lens,
                             sample_fn, char_cache)

    @torch.inference_mode()
    def generate_tunes(self, prompt: str, num_tunes: int = 1,
                       max_patch: int = 128, seed: Optional[int] = None,
                       show_control_code: bool = True) -> list[str]:
        """``num_tunes`` continuations of ``prompt`` in one batch (the
        reference's bar loop): the prompt is patch-encoded (special patches,
        eos dropped), its tail past the last patch boundary seeds the first
        bar, and a tune stops at an eos patch, an empty bar, or
        ``max_patch`` patches (capped at patch_length). S:/B:/E: bars are
        hidden unless ``show_control_code`` (they still condition)."""
        p = self.patchilizer
        S, L, B = self.cfg.patch_size, self.cfg.patch_length, num_tunes
        dev = self.model.device
        seed = 0 if seed is None else int(seed)
        gen = torch.Generator(device=dev)

        prompt_patches, remaining = prepare_patch_state(p, prompt, L, S)
        n0 = len(prompt_patches)
        patches = np.zeros((B, L, S), np.int32)
        patches[:, :n0] = np.asarray(prompt_patches, np.int32)
        n_patches = np.full((B,), n0, np.int32)
        tunes = [filter_control_codes(prompt, show_control_code)] * B
        patch_limit = min(max_patch, L)
        if n0 >= patch_limit:
            return tunes
        cache = self._prefill(torch.from_numpy(patches).to(dev), n0)
        char_cache = KVCache.create(self.cfg.char_core_config(), B,
                                    max_len=S, device=dev)
        # the patch each row feeds this bar: the prompt's last patch first,
        # then the bar just committed (stale for done rows: never read)
        new_patch = patches[:, n0 - 1].copy()
        done = np.zeros((B,), bool)
        carried = [remaining] * B

        for bar_idx in range(patch_limit):
            if done.all() or (n_patches >= patch_limit).all():
                break
            # one upload: init tokens, the feed patches, init lengths
            packed = np.zeros((B, 2 * S + 1), np.int32)
            packed[:, 0] = Patchilizer.bos_token_id
            packed[:, S:2 * S] = new_patch
            packed[:, 2 * S] = 1
            for b in range(B):
                if done[b]:
                    # no carried chars for finished rows: the fold index
                    # below is row 0's, and must be every live row's
                    continue
                # at most S-2 carried chars, so one can still be sampled
                chars = [ord(c) for c in carried[b]][: S - 2]
                packed[b, 1:1 + len(chars)] = chars
                packed[b, 2 * S] = 1 + len(chars)
            init_len0 = int(packed[0, 2 * S])
            dev_in = torch.from_numpy(packed).to(dev)

            def sample_fn(probs, j, bar_idx=bar_idx):
                gen.manual_seed(fold_seed(seed, bar_idx,
                                          max(j - init_len0, 0)))
                return sample_top_p_top_k_temperature(
                    probs, gen, self.top_p, self.top_k, self.temperature)

            tokens, lens = self._bar_step(
                cache, dev_in[:, S:2 * S], dev_in[:, :S], dev_in[:, 2 * S],
                sample_fn, char_cache)
            out = torch.cat([tokens, lens[:, None]], dim=1).cpu().numpy()
            tokens, lens = out[:, :S], out[:, S]
            init_lens = packed[:, 2 * S]

            for b in range(B):
                if done[b] or n_patches[b] >= patch_limit:
                    done[b] = True
                    continue
                new_tokens = tokens[b, init_lens[b]:lens[b]]
                if len(new_tokens) and \
                        new_tokens[0] == Patchilizer.eos_token_id:
                    done[b] = True
                    continue
                bar = p.patch2bar(new_tokens)
                if bar == "":
                    done[b] = True
                    continue
                tunes[b] += filter_generated_bar(bar, show_control_code)
                patch = p.bar2patch(carried[b] + bar, S)
                carried[b] = ""
                patches[b, n_patches[b]] = patch
                new_patch[b] = patch
                n_patches[b] += 1
        return tunes
