"""Batched autoregressive generation with a KV cache: the port of
``ai_music_generation_tpu/decode/generate.py``.

The protocol is the JAX Generator's:

- ragged prompts decode in lockstep: every row advances through the same
  positions, and while position t is still inside row i's prompt, the
  prompt token is committed instead of the sample;
- the common prompt prefix is prefilled at a power-of-two length;
- past the decode window (``window``, default block_size) the cache is
  refreshed: the last ``window - refresh`` tokens are re-prefilled at
  positions 0.. and decoding continues for ``refresh`` steps.

Each decode step runs eagerly and never syncs with the host: the cache
length, the prompt test and the sampling all stay on the device.

Every model call sees the tokens the JAX Generator's sees: the whole
power-of-two prefill bucket, every row of the batch (finished rows too) and
the same refresh length. An MoE model's routing couples the rows of a call
(the experts' capacity is shared), so this is what keeps its tokens equal
to JAX's.

Sampling draws from a ``torch.Generator`` seeded with ``seed``, consumed in
step order. JAX's ``fold_in`` streams cannot be reproduced, so the port's
contract is its own: the same seed and inputs give identical tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from ai_music_generation_tpu_torch.models.gpt import GPT, KVCache
from ai_music_generation_tpu_torch.utils import tracing


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus truncation: keep the smallest token set whose probability
    mass reaches ``top_p`` (ties at the threshold all kept), mask the rest
    to -inf. Works on [..., V]."""
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_p, dim=-1)
    k = (csum < top_p).sum(dim=-1, keepdim=True)
    thr = torch.gather(sorted_p, -1, k.clamp_max(probs.shape[-1] - 1))
    return logits.masked_fill(probs < thr, float("-inf"))


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The logits a draw samples from: fp32, divided by ``temperature``
    (> 0), top-k then top-p masked to -inf. ``logits`` [B, V]."""
    logits = logits.float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature, then top-k, then top-p (:func:`filter_logits`), then a
    categorical draw (Gumbel-max, as ``jax.random.categorical``). ``logits``
    [B, V]; returns int32 [B]. ``temperature == 0`` is greedy and draws
    nothing."""
    with tracing.span(tracing.DECODE_SAMPLE):
        if temperature == 0.0:
            return logits.float().argmax(dim=-1).to(torch.int32)
        logits = filter_logits(logits, temperature, top_k, top_p)
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (logits + gumbel).argmax(dim=-1).to(torch.int32)


class Generator:
    """Batched generator for a :class:`GPT`; see :meth:`generate`."""

    def __init__(
        self,
        model: GPT,
        max_new_tokens: int = 500,
        temperature: float = 0.8,
        top_k: Optional[int] = 200,
        refresh: Optional[int] = None,
        top_p: Optional[float] = None,
        window: Optional[int] = None,
    ):
        self.model = model
        self.block_size = model.config.block_size
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        # decode KV-cache length; a window smaller than block_size trades
        # guaranteed context (>= window - refresh tokens) for cache reads
        self.window = window or self.block_size
        if self.window > self.block_size:
            raise ValueError(
                "decode window cannot exceed block_size (position table size)")
        self.refresh = refresh or max(1, self.window // 2)
        if self.refresh >= self.window:
            raise ValueError("refresh must leave context")

    @torch.inference_mode()
    def generate(self, prompts, prompt_lens=None, seed: int = 1337):
        """Generate continuations for right-padded prompts.

        Args:
          prompts: int [B, P] (tensor, array or nested list), right-padded
            with any token.
          prompt_lens: int [B] true lengths (default: all P).
          seed: same seed + same inputs => identical output tokens.

        Returns:
          int32 [B, P + max_new_tokens] on the model's device; row i's
          generation occupies positions [prompt_lens[i], ...).
        """
        model, cfg = self.model, self.model.config
        device = model.transformer.wte.weight.device
        prompts = torch.as_tensor(prompts, dtype=torch.int32)
        if prompts.dim() == 1:
            prompts = prompts[None, :]
        B, P = prompts.shape
        lens = (torch.full((B,), P, dtype=torch.int32) if prompt_lens is None
                else torch.as_tensor(prompt_lens, dtype=torch.int32).cpu())
        prefill_len = max(min(int(lens.min()), self.window), 1)
        # power-of-two bucket, as the JAX Generator (there a static jit
        # argument); positions from the bucket to each prompt's true length
        # are replayed by the step's in-prompt branch
        prefill_len = 1 << (prefill_len.bit_length() - 1)
        lens = lens.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        total = P + self.max_new_tokens
        tokens = torch.zeros((B, total), dtype=torch.int32, device=device)
        tokens[:, :P] = prompts.to(device)

        def step(cache, logits, t):
            """Commit token t (prompt token or sample), then feed it."""
            with tracing.span(tracing.DECODE_STEP):
                sampled = sample_logits(logits[:, -1, :], gen,
                                        self.temperature, self.top_k,
                                        self.top_p)
                next_tok = torch.where(t < lens, tokens[:, t], sampled)
                tokens[:, t] = next_tok
                return model(next_tok[:, None], cache=cache)[0]

        with tracing.span(tracing.DECODE_PREFILL):
            cache = KVCache.create(cfg, B, max_len=self.window, device=device)
            logits, _ = model(tokens[:, :prefill_len], cache=cache)
        t = min(total, self.window)
        for tt in range(prefill_len, t):
            logits = step(cache, logits, tt)
        ctx = self.window - self.refresh
        while t < total:
            # re-prefill the last `ctx` tokens at positions 0..ctx-1 into a
            # fresh (zeroed) cache
            with tracing.span(tracing.DECODE_REFRESH):
                cache = KVCache.create(cfg, B, max_len=self.window,
                                       device=device)
                logits, _ = model(tokens[:, t - ctx:t], cache=cache)
            n_steps = min(self.refresh, total - t)
            for tt in range(t, t + n_steps):
                logits = step(cache, logits, tt)
            t += n_steps
        return tokens
