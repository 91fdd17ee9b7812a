"""Distribution-exact speculative decoding with prompt-lookup drafting: the
port of ``ai_music_generation_tpu/decode/speculative.py``.

Each verify step feeds a row's last committed token plus ``n_draft`` draft
tokens through one forward over the spec KV cache (``models.gpt.KVCache``
with ``spec=True``) and commits between 1 and ``n_draft + 1`` tokens, for
one read of the cache:

- drafting is prompt-lookup: the most recent earlier occurrence of the last
  two committed tokens proposes the tokens that followed it; positions
  still inside the prompt draft the prompt token and are force-accepted;
- acceptance is exact rejection sampling with a point-mass proposal: draft
  d is accepted with the model's probability p(d) (under the same
  temperature / top-k / top-p transform ``decode.generate.sample_logits``
  applies); on rejection the replacement is drawn from p with d masked out,
  so every committed token's marginal is exactly p.

Rows accept different numbers of drafts, yet every step writes all rows'
fresh K/V as one slab at the shared cursor; rejected drafts' columns are
re-marked dead in ``col_pos``. Past the cache's capacity the last
``block_size - refresh`` committed tokens are re-prefilled, which also
compacts the dead columns away.

The loop runs eagerly. Its one host sync per step is the stop test
(``any(lens < targets)``), as in the JAX loop's ``while_loop`` condition:
``n_steps`` then counts exactly the verify forwards JAX runs. Sampling
draws from a ``torch.Generator`` seeded with ``seed`` (the same seed and
inputs give identical tokens); JAX's threefry streams cannot be
reproduced, so only greedy decoding matches the JAX package token for
token.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_music_generation_tpu_torch.decode.generate import (
    apply_top_p,
    sample_logits,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, KVCache


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _roll_rows_left(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row variable left-roll: ``out[b, j] = x[b, (j + shift[b]) % n]``
    (a gather; the JAX version composes static rolls because gathers are
    slow on the TPU). The modulo wrap is part of the contract: near the
    buffer end it decides which tokens are proposed."""
    n = x.shape[1]
    idx = (torch.arange(n, device=x.device)[None, :]
           + shift.long()[:, None]) % n
    return torch.gather(x, 1, idx)


def _take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[b, j[b]]`` for x [B, W]."""
    return torch.gather(x, 1, j.long()[:, None])[:, 0]


def prompt_lookup_drafts(tokens: torch.Tensor, lens: torch.Tensor,
                         prompt_lens: torch.Tensor, n_draft: int):
    """Propose ``n_draft`` draft tokens per row from the sequence's own
    history, plus the forced (teacher-forcing) mask for in-prompt
    positions; returns (drafts [B, K] int32, forced [B, K] bool).

    The most recent position m in [1, lens-2] whose bigram
    ``(tokens[m-1], tokens[m])`` equals the final committed bigram proposes
    ``tokens[m+1 : m+1+n_draft]`` (indices taken modulo the buffer width);
    rows with no match repeat their last token. Positions still inside the
    prompt draft the known prompt token and are force-accepted."""
    drafts, forced, _ = _drafts_and_rolled(tokens, lens, prompt_lens, n_draft)
    return drafts, forced


def _drafts_and_rolled(tokens, lens, prompt_lens, n_draft):
    """prompt_lookup_drafts plus the lens-rolled token buffer (column j =
    ``tokens[(lens + j) % total]``), which the caller reuses for the step's
    other history reads (JAX speculative.py:106-137)."""
    total = tokens.shape[1]
    rolled = _roll_rows_left(tokens, lens)
    last1 = rolled[:, total - 1:total]  # tokens[lens - 1]
    last2 = rolled[:, total - 2:total - 1]  # tokens[(lens - 2) % total]
    m_idx = torch.arange(1, total, device=tokens.device)
    match = ((tokens[:, 1:] == last1) & (tokens[:, :-1] == last2)
             & (m_idx[None, :] <= (lens - 2)[:, None])
             & (lens[:, None] >= 3))
    best = torch.where(match, m_idx[None, :], 0).amax(dim=1)
    cand = _roll_rows_left(tokens, best + 1)[:, :n_draft]
    drafts = torch.where((best > 0)[:, None], cand, last1)
    pos = lens[:, None] + torch.arange(n_draft, device=tokens.device)
    forced = pos < prompt_lens[:, None]
    return torch.where(forced, rolled[:, :n_draft], drafts), forced, rolled


def keep_committed(cache: KVCache, cursor0, length0, commits, T: int):
    """After a verify step of T tokens written at ``cursor0`` for rows at
    ``length0``: keep the first ``commits[b]`` fresh columns of row b live
    (input 0 and the accepted drafts; the last committed token stays
    uncached), mark the rest dead, and rewind ``length`` to the next
    step's first-query position (JAX speculative.py:308-324)."""
    cols = torch.arange(cache.col_pos.shape[1], dtype=torch.int32,
                        device=cache.col_pos.device)
    rel = cols[None, :] - cursor0
    cache.col_pos = torch.where(
        (rel >= 0) & (rel < T),
        torch.where(rel < commits[:, None], length0[:, None] + rel,
                    KVCache.INVALID_POS),
        cache.col_pos)
    cache.length = length0 + commits


def reset_spec_cache(cache: KVCache) -> None:
    """A refresh's fresh start in the same buffers (JAX speculative.py:
    337-341): length and cursor 0, every column dead."""
    cache.length.zero_()
    cache.cursor.zero_()
    cache.col_pos.fill_(KVCache.INVALID_POS)


class SpecGenerator:
    """Batched speculative generator for a :class:`GPT` with an MHA
    (``n_kv_head`` None or equal to ``n_head``) model.

    Same ``generate`` contract as :class:`decode.generate.Generator`,
    committing up to ``n_draft + 1`` tokens per model step. The sampled
    distribution is exactly the Generator's; the token stream at a given
    seed differs, because the random numbers are drawn per step rather
    than per position.
    """

    def __init__(
        self,
        model: GPT,
        max_new_tokens: int = 500,
        temperature: float = 0.8,
        top_k: Optional[int] = 200,
        n_draft: int = 4,
        refresh: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        if n_draft < 1:
            raise ValueError("n_draft must be at least 1")
        self.model = model
        self.block_size = model.config.block_size
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.n_draft = n_draft
        self.refresh = refresh or max(1, self.block_size // 2)
        # context re-prefilled at refresh: the same window as Generator
        self.window = self.block_size - self.refresh
        if self.window < 1:
            raise ValueError("refresh must leave context")
        # the cursor is 8-aligned: after a refresh it sits at ceil8(window)
        # and each step consumes ceil8(n_draft + 1) columns; at least one
        # step must fit
        if _ceil8(self.window) + _ceil8(n_draft + 1) > self.block_size:
            raise ValueError(
                "refresh window leaves no room for a draft chain; lower "
                "n_draft or raise refresh")

    def generate(self, prompts, prompt_lens=None, seed: int = 1337):
        """Same contract as ``decode.generate.Generator.generate``."""
        return self.generate_with_stats(prompts, prompt_lens, seed)[0]

    @torch.inference_mode()
    def generate_with_stats(self, prompts, prompt_lens=None,
                            seed: int = 1337):
        """(tokens, n_steps): tokens int32 [B, P + max_new_tokens] on the
        model's device (row i's generation from ``prompt_lens[i]`` on);
        n_steps, the number of verify forwards run. Committed tokens per
        step = (P + max_new_tokens - prefill bucket) / n_steps."""
        model, cfg = self.model, self.model.config
        device = model.transformer.wte.weight.device
        prompts = torch.as_tensor(prompts, dtype=torch.int32)
        if prompts.dim() == 1:
            prompts = prompts[None, :]
        B, P = prompts.shape
        plens = (torch.full((B,), P, dtype=torch.int32) if prompt_lens is None
                 else torch.as_tensor(prompt_lens, dtype=torch.int32).cpu())
        # power-of-two prefill bucket, as the JAX SpecGenerator
        F_ = max(min(int(plens.min()), self.window), 1)
        F_ = 1 << (F_.bit_length() - 1)
        plens = plens.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        K, T, S, C = self.n_draft, self.n_draft + 1, self.block_size, \
            self.window
        Tw = _ceil8(T)
        V = cfg.vocab_size
        total = P + self.max_new_tokens
        tokens = torch.zeros((B, total), dtype=torch.int32, device=device)
        tokens[:, :P] = prompts.to(device)
        # every row fills the whole buffer (the lockstep contract)
        targets = torch.full((B,), total, dtype=torch.int32, device=device)
        vocab = torch.arange(V, device=device)

        # Invariant: the cache holds K/V for row i's committed tokens at
        # window positions [0, length[i]); the LAST committed token (buffer
        # index lens[i] - 1) is never cached yet: it is each step's first
        # input (JAX speculative.py:212-218).
        cache = KVCache.create(cfg, B, max_len=S, device=device, spec=True)
        if F_ >= 2:
            model(tokens[:, :F_ - 1], cache=cache)
        lens = torch.full((B,), F_, dtype=torch.int32, device=device)

        def spec_step(tokens, lens):
            """One verify forward, acceptance, and the commits
            (JAX speculative.py:224-325); returns (tokens, lens)."""
            drafts, forced, rolled = _drafts_and_rolled(tokens, lens, plens, K)
            x = torch.cat([rolled[:, -1:], drafts], dim=1)  # [B, T]
            cursor0, length0 = cache.cursor.clone(), cache.length.clone()
            logits, _ = model(x, cache=cache, return_all_logits=True)
            lg = logits.float()
            if self.temperature > 0:
                lg = lg / self.temperature
                if self.top_k is not None and self.top_k < V:
                    kth = torch.topk(lg, self.top_k, dim=-1).values[..., -1:]
                    lg = lg.masked_fill(lg < kth, float("-inf"))
                if self.top_p is not None and self.top_p < 1.0:
                    # the nucleus transform sample_logits applies: exactness
                    # needs p(draft) and the residual from that distribution
                    lg = apply_top_p(lg, self.top_p)
                probs = torch.softmax(lg, dim=-1)  # [B, T, V]
                p_draft = torch.gather(probs[:, :K], 2,
                                       drafts.long()[..., None])[..., 0]
            else:
                p_draft = (drafts == lg[:, :K].argmax(dim=-1)).float()
            # accept draft d with probability p(d) ...
            u = torch.rand((B, K), generator=gen, device=device)
            ok = forced | (u < p_draft)
            a = torch.cumprod(ok.int(), dim=1).sum(dim=1, dtype=torch.int32)
            # ... on rejection draw the replacement from p with d masked
            # out; on full acceptance the bonus token from p at K
            lg_a = torch.gather(lg, 1, a.long()[:, None, None].expand(
                B, 1, V))[:, 0]
            rej_tok = _take(drafts, a.clamp_max(K - 1))
            lg_res = lg_a.masked_fill(
                (a < K)[:, None] & (vocab[None, :] == rej_tok[:, None]),
                float("-inf"))
            s = sample_logits(lg_res, gen,
                              1.0 if self.temperature > 0 else 0.0)
            # teacher forcing for the sampled slot too, while in-prompt
            s = torch.where(lens + a < plens, _take(rolled[:, :K + 1], a), s)
            # rows at their target commit nothing (and stop advancing)
            commits = torch.minimum(a + 1, (targets - lens).clamp_min(0))

            # committed tokens -> buffer positions lens .. lens+commits-1:
            # d_1 .. d_a, then the sampled token
            j_rel = (torch.arange(total, device=device)[None, :]
                     - lens[:, None])
            drafts_pad = torch.cat([drafts, torch.zeros(
                (B, total - K), dtype=torch.int32, device=device)], dim=1)
            wvals = _roll_rows_left(drafts_pad, total - lens)
            wvals = torch.where(j_rel == a[:, None], s[:, None], wvals)
            tokens = torch.where(
                (j_rel >= 0) & (j_rel < commits[:, None]), wvals, tokens)

            # the model marked all T fresh columns live; keep `commits`
            keep_committed(cache, cursor0, length0, commits, T)
            return tokens, lens + commits

        def refresh(tokens, lens):
            """Re-prefill the last `window` committed tokens (minus the
            uncached last one) at window positions 0.. into the same
            buffers, compacting the dead columns away (JAX
            speculative.py:327-351)."""
            start = (lens - 1 - C).clamp_min(0)
            ctx = _roll_rows_left(tokens, start)[:, :C]
            reset_spec_cache(cache)
            model(ctx, cache=cache)
            # rows shorter than the window prefilled garbage past their
            # length: those columns die, and the length is clamped
            nvalid = (lens - 1).clamp_max(C)
            cols = torch.arange(S, device=device)
            cache.col_pos = torch.where(cols[None, :] < nvalid[:, None],
                                        cache.col_pos, KVCache.INVALID_POS)
            cache.length = nvalid

        def unfinished(lens):
            return bool((lens < targets).any())  # the host sync of a step

        # the cursor advances exactly Tw per step from a known start, so each
        # window runs a fixed budget of steps before the next refresh
        n_steps = 0
        start = _ceil8(F_ - 1) if F_ >= 2 else 0
        while True:
            for _ in range((S - start) // Tw):
                if not unfinished(lens):
                    break
                tokens, lens = spec_step(tokens, lens)
                n_steps += 1
            if not unfinished(lens):
                return tokens, n_steps
            refresh(tokens, lens)
            start = _ceil8(C)
