"""Bulk sampling: whole ``Generator.generate`` calls back to back, closed
loop (the next batch starts when the last one has ended), as the port's
sampling CLI runs them.

Traffic keys: ``batch`` rows a call, ``prompt_len`` random prompt tokens,
``new_tokens`` a row, ``temperature`` and ``top_k`` of the sampled calls,
``greedy_every`` (call i is greedy when ``i % greedy_every == 0``: the
rows the check judges; the window ends on a whole cycle of calls, so every
window holds the same mix), ``check_rows`` rows judged a kind. The
configuration's ``decode`` section gives the cache (``kv_quantized``,
``flat_kv``) and the ``window`` (default ``block_size``; refreshed every
``window // 2`` tokens past it).

The check: once the window has closed and the program is freed, rows drawn
from the seed among the greedy calls' rows (and, where ``top_k`` filters
the vocabulary, among the sampled calls' rows) are run through the plain
reference, each generated token from the context the windowed decode gave
it. ``greedy_gap``: the widest gap by which a greedy token's reference
logit lies below the reference's best, and ``greedy_gap_mean`` the mean of
that gap over the judged greedy tokens (steadier from seed to seed than
the widest); ``topk_gap``: the widest by which a
sampled token's reference logit lies below the reference's ``top_k``-th;
``prompt_changed``: prompt tokens of the judged rows that the served row
does not hold.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import program, weights, yardstick
from port_bench.reference import gpt_ref
from port_bench.reference.precision import Precision, ieee_fp32

END_TO_END = ("decode_tok_s",)


def _mix(seed: int, i: int) -> int:
    return (seed * 1_000_003 + i * 7_919 + 1) % (1 << 62)


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.model_cfg = config["model"]
        dec = config["decode"]
        self.quantized = dec["kv_quantized"]
        self.flat_kv = dec["flat_kv"]
        self.window = dec.get("window") or self.model_cfg["block_size"]
        self.refresh = max(1, self.window // 2)
        self.t = traffic
        self.seed, self.device = seed, torch.device(device)
        self.B, self.P = traffic["batch"], traffic["prompt_len"]
        self.new = traffic["new_tokens"]
        self.V = self.model_cfg["vocab_size"]
        self.top_k = traffic["top_k"]
        self.filters = self.top_k is not None and self.top_k < self.V
        self.outputs = {}

    # -- inputs ------------------------------------------------------------
    def prompts(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix(self.seed, i))
        return torch.randint(0, self.V, (self.B, self.P), generator=gen,
                             device=self.device, dtype=torch.int32)

    def greedy(self, i: int) -> bool:
        return i % self.t["greedy_every"] == 0

    # -- the program -------------------------------------------------------
    def setup(self) -> None:
        from ai_music_generation_tpu_torch.decode.generate import Generator

        t0 = time.perf_counter()
        self.model, _ = program.build_gpt(
            self.model_cfg, self.seed, self.device,
            kv_quantized=self.quantized, flat_kv=self.flat_kv)
        program.sync(self.device)
        t1 = time.perf_counter()

        def generator(new_tokens, temperature):
            return Generator(self.model, max_new_tokens=new_tokens,
                             temperature=temperature, top_k=self.top_k,
                             window=self.window, refresh=self.refresh)

        self.sampled = generator(self.new, self.t["temperature"])
        self.greedy_gen = generator(self.new, 0.0)
        # every shape the window runs: the first encode, the steps and, past
        # the window, one refill and a step after it
        total = self.P + self.new
        warm = (self.window - self.P + 1 if total > self.window else 2)
        generator(min(warm, self.new), self.t["temperature"]).generate(
            self.prompts(-1), seed=_mix(self.seed, -1))
        program.sync(self.device)
        self.phases = {"model_and_weights": t1 - t0,
                       "warm_up": time.perf_counter() - t1}

    def window_run(self, seconds: float) -> dict:
        i = 0
        start = time.perf_counter()
        while True:
            with torch.profiler.record_function("port_bench.generate"):
                gen = self.greedy_gen if self.greedy(i) else self.sampled
                tokens = gen.generate(self.prompts(i), seed=_mix(self.seed, i))
                program.sync(self.device)
            if self.greedy(i) or self.filters:
                self.outputs[i] = tokens
            i += 1
            if (i % self.t["greedy_every"] == 0
                    and time.perf_counter() - start >= seconds):
                break
        elapsed = time.perf_counter() - start
        return {"calls": i, "elapsed": elapsed, "attempted": i * self.B,
                "failed": 0}

    def end_to_end(self, window: dict) -> dict:
        return {"decode_tok_s": window["calls"] * self.B * self.new
                / window["elapsed"]}

    def release(self) -> None:
        self.model = self.sampled = self.greedy_gen = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    # -- the check ---------------------------------------------------------
    def _rows(self, greedy: bool, salt: int):
        calls = sorted(i for i in self.outputs if self.greedy(i) == greedy)
        rng = np.random.default_rng([self.seed, salt])
        n = min(self.t["check_rows"], len(calls) * self.B)
        picks = rng.choice(len(calls) * self.B, size=n, replace=False)
        picks = [(calls[p // self.B], int(p % self.B)) for p in sorted(picks)]
        tokens = torch.stack([self.outputs[c][r] for c, r in picks])
        prompts = torch.stack([self.prompts(c)[r] for c, r in picks])
        return tokens.long(), prompts.long()

    def served(self, prec: Precision, tokens: torch.Tensor) -> torch.Tensor:
        _, w = weights.make(self.model_cfg, self.seed, self.device)
        with ieee_fp32():
            return gpt_ref.served_logits(w, self.model_cfg, tokens, self.P,
                                         self.window, self.refresh, prec)

    def precision(self) -> Precision:
        return Precision("fp32", 8 if self.quantized else None)

    def check(self) -> dict:
        numbers = {}
        tokens, prompts = self._rows(True, 1)
        ref = self.served(self.precision(), tokens)
        gap = ref.amax(-1) - ref.gather(-1, tokens[:, self.P:, None])[..., 0]
        numbers["greedy_gap"] = float(gap.max())
        numbers["greedy_gap_mean"] = float(gap.mean())
        changed = int((tokens[:, :self.P] != prompts).sum())
        if self.filters:
            tokens, prompts = self._rows(False, 2)
            ref = self.served(self.precision(), tokens)
            kth = ref.topk(self.top_k, dim=-1).values[..., -1]
            got = ref.gather(-1, tokens[:, self.P:, None])[..., 0]
            numbers["topk_gap"] = float((kth - got).clamp_min(0).max())
            changed += int((tokens[:, :self.P] != prompts).sum())
        numbers["prompt_changed"] = float(changed)
        return numbers

    def control(self) -> dict:
        """The reference one step below the stated precision in the
        program's place, read at the same rows, prompts and tokens: the gap
        of the token it puts first (greedy rows), and of a token it samples
        under its own filter (sampled rows)."""
        low = self.precision().lowered()
        numbers = {}
        tokens, _ = self._rows(True, 1)
        ref = self.served(self.precision(), tokens)
        pick = self.served(low, tokens).argmax(-1, keepdim=True)
        gap = ref.amax(-1) - ref.gather(-1, pick)[..., 0]
        numbers["greedy_gap"] = float(gap.max())
        numbers["greedy_gap_mean"] = float(gap.mean())
        if self.filters:
            tokens, _ = self._rows(False, 2)
            ref = self.served(self.precision(), tokens)
            low_logits = self.served(low, tokens) / self.t["temperature"]
            kth_low = low_logits.topk(self.top_k, dim=-1).values[..., -1:]
            probs = low_logits.masked_fill(low_logits < kth_low,
                                           float("-inf")).softmax(-1)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_mix(self.seed, 99))
            pick = torch.multinomial(probs.reshape(-1, self.V), 1,
                                     generator=gen).reshape(*probs.shape[:2], 1)
            kth = ref.topk(self.top_k, dim=-1).values[..., -1]
            got = ref.gather(-1, pick)[..., 0]
            numbers["topk_gap"] = float((kth - got).clamp_min(0).max())
        return numbers

    # -- what the readers count --------------------------------------------
    def calls_per_generate(self):
        return yardstick.decode_calls(self.P, self.new, self.window,
                                      self.refresh)
