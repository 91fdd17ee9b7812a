"""Continuous-batching generation engine: the port of
``ai_music_generation_tpu/serve/engine.py`` (the GPT ``GenerationServer``).

Requests arrive at any time, run concurrently in the fixed SLOTS of one
decode batch, and leave as they finish (iteration-level batching) on the
ring :class:`~ai_music_generation_tpu_torch.models.gpt.KVCache`
(``per_row=True``):

- ONE decode batch of ``[n_slots]`` rows; every row ticks each step but
  sits at its OWN position (per-row cache lengths, positions and ring
  masks). Each tick runs the model once with a T=1 step per slot: on the
  card that is K1 (``ops/gqa_decode.py``) once per layer, with the ring
  mask. ``ticks_per_call`` ticks run per :meth:`GenerationServer.step`
  with no host sync inside; the step's tokens come back to the host as ONE
  packed uint16 ``[K, B]`` download (token | emitted << 14 | done << 15)
  when the vocabulary fits 14 bits, and the host demultiplexes them.
- Admission = insert-prefill: queued prompts (and window refreshes) are
  prefilled as a batch of G rows (G = 8, or ``admit_group`` when more
  than 8 wait) at one power-of-two prompt bucket, on a lockstep cache; each
  row is rolled so its prompt ends at the ring cursor and scattered into
  its slot. One host-to-device upload carries the whole admission list.
- Per-request sampling parameters (temperature, top_k, top_p, stop_token,
  max_new_tokens, seed) are [B] tensors, so one batch serves mixed
  requests; ``temperature <= 0`` is greedy, ``top_k <= 0`` no top-k filter,
  ``top_p >= 1`` no nucleus filter.
- Long generations use the windowed-refresh contract of
  ``decode/generate.py``: before a slot's cache could pass ``cache_len`` in
  the next call, the host (which mirrors every length, so it never reads
  the device to decide) re-prefills its last ``cache_len - refresh`` tokens.
- A cancelled in-flight request is deactivated on the device by an
  internal zero-budget admit into its slot.

RNG contract. JAX draws token g of a request with seed s from
``fold_in(PRNGKey(s), g)``, which torch cannot reproduce. The port keeps the
contract with its own counter-based noise: the draw is Gumbel-max, token
``argmax(filtered logits + G)``, where the noise of vocabulary index v is a
function of (s, g, v) alone:

    mix(h)  = murmur3's 32-bit finalizer (h ^= h >> 16; h *= 0x85EBCA6B;
              h ^= h >> 13; h *= 0xC2B2AE35; h ^= h >> 16), mod 2^32
    row     = mix(mix(s ^ 0x243F6A88) ^ g)
    bits    = mix(row ^ (v * 0x9E3779B1 mod 2^32))
    u       = (2 * (bits >> 9) + 1) / 2^24          (exact in fp32, in (0, 1))
    G       = -log(-log(u))

The hash is integer arithmetic in plain torch ops on int64 (no product
reaches 2^63), so it gives the same bits on the CPU and the card. A
request's output therefore does not depend on its slot, on the batch
composition or on when it arrived (up to the floating-point differences of
other batch shapes in the prefill's matrix products). An MoE model is the
exception: its experts' capacity is shared by the rows of a call, so a
row's routing, and its tokens, depend on the other slots; every slot ticks,
idle ones included, as in JAX, so the port's engine routes the tokens the
JAX engine routes.

Slots whose request finished keep ticking masked (``active`` False pins
their cache length and logits) until new work is admitted.

Sharded serving (``mesh=``, JAX :229-368): the engine runs in every
process of a (data, model) ``DeviceMesh`` (``parallel/mesh.py::
make_mesh``) under ``serve/mesh.py``'s control plane. The model is split
over the model axis (``parallel/sharding.py::parallelize``, no FSDP: no
optimizer state) and every rank holds ``n_slots / n_data`` slot rows, its
data shard, with a cache of its K/V heads. Rank 0 accepts ``submit`` and
``cancel``, keeps the queue, the slot table and the ``_lengths`` mirror,
and each step broadcasts the admission upload; every rank prefills the
whole wave (the unsharded engine's batch shape) and scatters the rows of
its slots, runs the ticks on its rows and sends its ``[K, B_local]``
tokens to rank 0, which demultiplexes. The other ranks call
:meth:`GenerationServer.follow`, which returns at :meth:`GenerationServer.
shutdown`'s stop packet. Every rank does the same cursor arithmetic, so
the ring cursor is equal everywhere. MoE routing follows JAX's two
programs: on the einsum path (``flat_kv`` False, GSPMD) a tick routes all
``n_slots`` rows together (the gathered capacity counts of
``models/moe.py``); on the flat path (JAX's ``shard_map`` over the data
axis) each data shard routes its own rows; the admission prefill routes
its wave, as the unsharded engine does.
"""

from __future__ import annotations

import dataclasses
import itertools
import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ai_music_generation_tpu_torch.models.gpt import GPT, KVCache
from ai_music_generation_tpu_torch.models.moe import local_routing
from ai_music_generation_tpu_torch.serve.mesh import STOP, STEP, MeshLink
from ai_music_generation_tpu_torch.utils.hash32 import GOLDEN
from ai_music_generation_tpu_torch.utils.hash32 import M32 as _M32
from ai_music_generation_tpu_torch.utils.hash32 import mix32 as _mix32
from ai_music_generation_tpu_torch.utils.hash32 import mul32 as _mul32


@dataclasses.dataclass(eq=False)  # identity equality: queue removal must
class Request:                    # never confuse two same-parameter requests
    id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    seed: int
    stop_token: int  # -1 = none
    top_p: float = 1.0  # >= 1.0 disables the nucleus filter
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    internal: bool = False  # engine-internal (slot deactivation); never reported
    submitted_at: float = 0.0  # perf_counter at submit()
    finished_at: float = 0.0  # perf_counter when demuxed as done

    @property
    def tokens(self) -> list[int]:
        return self.prompt + self.generated


def noise_bits(seed: torch.Tensor, gen: torch.Tensor, vocab: int) -> torch.Tensor:
    """The 32 random bits of each (row, vocabulary index), int64 [B, V]:
    a function of (seed[b], gen[b], v) only (module docstring). ``seed``
    holds uint32 values in an int64 tensor, ``gen`` the tokens generated."""
    seed = seed.to(torch.int64) & _M32
    row = _mix32(_mix32(seed ^ 0x243F6A88) ^ (gen.to(torch.int64) & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    return _mix32(row[:, None] ^ _mul32(v, GOLDEN)[None, :])


def gumbel_noise(seed: torch.Tensor, gen: torch.Tensor, vocab: int) -> torch.Tensor:
    """fp32 [B, V] standard Gumbel noise from :func:`noise_bits`."""
    u = ((noise_bits(seed, gen, vocab) >> 9) * 2 + 1).to(torch.float32) \
        * 2.0 ** -24
    return -torch.log(-torch.log(u))


def keep_filter(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row temperature, top-k and top-p (the vector form of
    ``decode/generate.py::filter_logits``; JAX ``_per_slot_sample`` up to
    its draw): fp32 ``logits / max(temperature, 1e-6)`` with every token
    outside the row's keep-set at -inf. Top-k keeps the values >= the row's
    k-th largest (ties kept; ``top_k <= 0`` keeps all); top-p then keeps the
    values >= the k_p-th of the sorted masked row, k_p the number of sorted
    softmax prefix sums below ``top_p`` (``top_p >= 1`` keeps all).
    ``logits`` [B, V]; the parameters are [B] tensors."""
    V = logits.shape[-1]
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    vals_desc = torch.sort(scaled, dim=-1, descending=True).values
    eff_k = torch.where(top_k > 0, top_k, V).to(torch.int64)
    kth = torch.gather(vals_desc, 1, (eff_k[:, None] - 1).clamp(0, V - 1))
    masked = scaled.masked_fill(scaled < kth, float("-inf"))
    # top-p over the survivors: the values < kth are the tail of vals_desc
    n_kept = (scaled >= kth).sum(dim=-1, keepdim=True)
    sorted_masked = vals_desc.masked_fill(
        torch.arange(V, device=logits.device)[None, :] >= n_kept,
        float("-inf"))
    csum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    k_p = (csum < top_p[:, None]).sum(dim=-1, keepdim=True)
    thr = torch.gather(sorted_masked, 1, k_p.clamp(0, V - 1))
    return masked.masked_fill((top_p < 1.0)[:, None] & (masked < thr),
                              float("-inf"))


def _per_slot_sample(logits, seed, gen, temperature, top_k, top_p):
    """One token per row (int32 [B]): greedy where ``temperature <= 0``,
    else Gumbel-max over :func:`keep_filter` with the row's counter noise."""
    greedy = logits.float().argmax(dim=-1)
    masked = keep_filter(logits, temperature, top_k, top_p)
    sampled = (masked + gumbel_noise(seed, gen, logits.shape[-1])).argmax(
        dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


class EngineHostBase:
    """Host bookkeeping of a serving engine: finished-queue draining,
    idle-driving, cancellation plumbing and latency observability."""

    # subclasses create: _queue, _slots, _finished, _live, _cancelled,
    # _latencies (deque), and optionally a `stats` dict of counters

    def _drain_finished(self) -> list:
        out = list(self._finished)
        self._finished.clear()
        return out

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    def run_until_idle(self) -> list:
        """Drive :meth:`step` until queue and slots drain; returns all
        finished requests (arrival order not guaranteed)."""
        out = []
        while self.busy:
            out.extend(self.step())
        return out

    def cancel(self, rid: int) -> bool:
        """Request cancellation of a queued or in-flight request; returns
        True if the request is live. Safe from any thread: only the engine
        thread mutates queue and slots, applying pending cancellations at
        the start of its next step."""
        req = self._live.get(rid)
        if req is None or req.done:
            return False
        self._cancelled.add(rid)
        return True

    def reset_stats(self) -> None:
        """Zero the phase accounting (if any) and the latency window
        (benchmarks call this between warm-up and timed passes)."""
        for k, v in getattr(self, "stats", {}).items():
            self.stats[k] = type(v)()
        self._latencies.clear()

    def latency_stats(self) -> dict:
        """p50/p95/p99/mean request completion latency (submit -> finished
        demux, seconds) over the last <= 10k finished requests."""
        if not self._latencies:
            return {"count": 0}
        lat = np.sort(np.asarray(self._latencies, np.float64))
        q = lambda p: float(lat[min(int(p * len(lat)), len(lat) - 1)])  # noqa: E731
        return {
            "count": len(lat),
            "p50_s": round(q(0.50), 4),
            "p95_s": round(q(0.95), 4),
            "p99_s": round(q(0.99), 4),
            "mean_s": round(float(lat.mean()), 4),
            "max_s": round(float(lat[-1]), 4),
        }


class GenerationServer(EngineHostBase):
    """Continuous-batching decode server over a :class:`GPT` (its weights
    and device are the model's).

    Usage::

        srv = GenerationServer(model, n_slots=64)
        rid = srv.submit([1, 2, 3], max_new_tokens=100, seed=7)
        for req in srv.run_until_idle():
            print(req.id, req.generated)

    or drive incrementally with :meth:`step` (admits queued work, runs
    ``ticks_per_call`` decode ticks, returns the requests finished so far).

    ``mesh``: a (data, model) ``DeviceMesh`` over every process (module
    docstring); every rank builds the server over the same whole model,
    which it splits in place; rank 0 serves and the others call
    :meth:`follow`. ``n_slots`` must divide evenly over the data axis.
    """

    def __init__(
        self,
        model: GPT,
        n_slots: int = 64,
        ticks_per_call: int = 32,
        refresh: Optional[int] = None,
        admit_group: int = 64,
        cache_len: Optional[int] = None,
        mesh=None,
    ):
        cfg = model.config
        self.model = model
        self.device = model.transformer.wte.weight.device
        self.n_slots = n_slots
        self.block_size = cfg.block_size
        # the ring-cache length (default block_size): a shorter cache
        # trades guaranteed context (every token still sees >= cache_len -
        # refresh committed tokens) for tick bandwidth
        self.cache_len = cache_len or cfg.block_size
        if not 8 <= self.cache_len <= cfg.block_size:
            raise ValueError(
                f"cache_len={self.cache_len} must be in [8, block_size="
                f"{cfg.block_size}] (positions are embedded at their true "
                "in-window index, which the wpe table must cover)")
        self.refresh = refresh or max(1, self.cache_len // 2)
        if ticks_per_call > self.refresh:
            raise ValueError(
                f"ticks_per_call={ticks_per_call} must be <= refresh="
                f"{self.refresh} (a slot must survive one call without "
                "overflowing its cache window)")
        if self.refresh >= self.cache_len:
            raise ValueError(
                f"refresh={self.refresh} must be < cache_len="
                f"{self.cache_len} (window = cache_len - refresh is the "
                "context kept across a refresh; 0 would disable prompt "
                "truncation and overflow the ring cache)")
        self.ticks_per_call = ticks_per_call
        self.admit_group = admit_group
        self.window = self.cache_len - self.refresh

        self._queue: deque[Request] = deque()
        self._slots: list[Optional[Request]] = [None] * n_slots
        self._ids = itertools.count()
        self._finished: deque[Request] = deque()
        # host mirror of cache.length (admission plen + one per active
        # tick, rebuilt exactly from the demux): the refresh check never
        # reads the device
        self._lengths = np.zeros(n_slots, np.int64)
        # cancellation: producer threads only touch these two structures
        # (atomic dict/set operations); the engine thread applies them
        self._live: dict[int, Request] = {}
        self._cancelled: set[int] = set()
        # host wall time per step phase (observability; serve_bench prints
        # it); scan_s is the enqueue of the ticks, fetch_s the wait for them
        self.stats = {"steps": 0, "admit_waves": 0, "admit_s": 0.0,
                      "scan_s": 0.0, "fetch_s": 0.0, "demux_s": 0.0}
        # per-request completion latency (submit -> finished demux), bounded
        self._latencies: deque = deque(maxlen=10_000)

        V, dev = cfg.vocab_size, self.device
        # on a mesh: this rank's slot rows, and the ticks' MoE routing (the
        # flat path routes each data shard alone, as JAX's shard_map)
        self.link, rows, kv_heads = None, n_slots, None
        if mesh is not None:
            from ai_music_generation_tpu_torch.parallel.sharding import (
                parallelize,
            )

            self.link = MeshLink(mesh, n_slots)
            rows = self.link.rows
            parallelize(model, self.link.layout, data_parallel=False)
            kv_heads = model.transformer.h[0].attn.cache_heads()
        self._local_ticks = cfg.flat_kv

        def full(value, dtype, shape=(rows,)):
            return torch.full(shape, value, dtype=dtype, device=dev)

        self.cache = KVCache.create(cfg, rows, max_len=self.cache_len,
                                    device=dev, per_row=True,
                                    kv_heads=kv_heads)
        self.last_logits = full(0.0, torch.float32, (rows, V))
        self.gen = full(0, torch.int32)
        self.max_new = full(0, torch.int32)
        self.temperature = full(1.0, torch.float32)
        self.top_k = full(V, torch.int32)
        self.top_p = full(1.0, torch.float32)
        self.stop_token = full(-1, torch.int32)
        self.seed = full(0, torch.int64)  # uint32 values
        self.active = full(False, torch.bool)

    # -- device work --------------------------------------------------------

    def _scan(self):
        """Enqueue ``ticks_per_call`` decode ticks with no host sync;
        returns (packed [K, B] int16 holding uint16 bits, None, None) on the
        device when the vocabulary fits 14 bits, else (toks, emitted, done)
        [K, B]."""
        toks, emitted, dones = [], [], []
        with local_routing(self._local_ticks):
            self._ticks(toks, emitted, dones)
        toks, emitted, dones = (torch.stack(x) for x in (toks, emitted, dones))
        if self.model.config.vocab_size <= 16384:
            # ONE download: tok | emitted << 14 | done << 15 as uint16 bits
            packed = (toks | (emitted.to(torch.int32) << 14)
                      | (dones.to(torch.int32) << 15))
            packed = torch.where(packed >= 1 << 15, packed - (1 << 16), packed)
            return packed.to(torch.int16), None, None
        return toks, emitted, dones

    def _ticks(self, toks, emitted, dones) -> None:
        for _ in range(self.ticks_per_call):
            active = self.active
            tok = _per_slot_sample(self.last_logits, self.seed, self.gen,
                                   self.temperature, self.top_k, self.top_p)
            tok = torch.where(active, tok, 0)
            logits, _ = self.model(tok[:, None], cache=self.cache)
            # freeze inactive rows: length pinned, logits kept (their stale
            # ring columns drift out of the window; they are dead anyway)
            self.cache.length -= (~active).to(torch.int32)
            self.last_logits = torch.where(
                active[:, None], logits[:, 0].float(), self.last_logits)
            self.gen = self.gen + active.to(torch.int32)
            hit_stop = (self.stop_token >= 0) & (tok == self.stop_token)
            done = active & ((self.gen >= self.max_new) | hit_stop)
            self.active = active & ~done
            toks.append(tok)
            emitted.append(active)
            dones.append(done)

    def _insert_many(self, packed: torch.Tensor, n_valid: int,
                     keep=None) -> None:
        """Admit one wave: ``packed`` [G, Pc + 10] int32 on the device, each
        row the padded context followed by (slot, plen, max_new, top_k,
        stop_token, g0, valid, seed: u32 bits, top_p: f32 bits,
        temperature: f32 bits); the first ``n_valid`` rows are requests, the
        rest padding. Batch-G prefill of the contexts on a lockstep cache,
        each valid row rolled so its context ends at the ring cursor, then
        scattered to its slot. On a mesh ``keep`` (a slice or a device
        index, ``MeshLink.mine``) picks the valid rows whose slots are this
        rank's; the whole wave is prefilled."""
        cfg = self.model.config
        G = packed.shape[0]
        ctx = packed[:, :-10]
        mine = slice(0, n_valid) if keep is None else keep
        rows = packed[mine]
        slots = rows[:, -10].long()
        if self.link is not None:
            slots = slots - self.link.base
        plens = packed[:, -9]
        pre = KVCache.create(cfg, G, max_len=self.cache_len,
                             device=self.device,
                             kv_heads=self.cache.k[0].shape[2] // cfg.head_dim)
        with local_routing():
            logits, _ = self.model(ctx, cache=pre, return_all_logits=True)
        picked = torch.arange(G, device=self.device)[mine]
        last = logits[picked, plens[mine].long() - 1].float()
        # the prefill wrote context token p at column p; the ring expects it
        # at (cursor - plen + p) mod S
        S = self.cache_len
        shifts = (self.cache.cursor - plens[mine]) % S
        src = (torch.arange(S, device=self.device)[None, :]
               - shifts[:, None]) % S  # [n, S]: rolled[j] = pre[src[j]]
        cache = self.cache
        for bufs, new in ((cache.k, pre.k), (cache.v, pre.v)):
            for buf, p in zip(bufs, new):
                idx = src[:, :, None].expand(-1, -1, p.shape[2])
                buf[slots] = torch.gather(p[mine], 1, idx)
        if cache.k_scale is not None:
            for bufs, new in ((cache.k_scale, pre.k_scale),
                              (cache.v_scale, pre.v_scale)):
                for buf, p in zip(bufs, new):
                    idx = src[:, None, :].expand(-1, p.shape[1], -1)
                    buf[slots] = torch.gather(p[mine], 2, idx)
        cache.length[slots] = plens[mine]
        self.last_logits[slots] = last
        self.max_new[slots] = rows[:, -8]
        self.top_k[slots] = rows[:, -7]
        self.stop_token[slots] = rows[:, -6]
        self.gen[slots] = rows[:, -5]
        self.seed[slots] = rows[:, -3].long() & _M32
        self.top_p[slots] = rows[:, -2].contiguous().view(torch.float32)
        self.temperature[slots] = rows[:, -1].contiguous().view(torch.float32)
        self.active[slots] = True

    # -- host orchestration --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 500,
               temperature: float = 0.8, top_k: int = 200,
               seed: int = 1337, stop_token: int = -1,
               top_p: float = 1.0) -> int:
        """Queue a request; returns its id. Safe for producer threads beside
        one engine thread (deque append / popleft)."""
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            # a tick samples before it tests gen >= max_new, so a 0 budget
            # would still emit one token (the internal cancel admit builds
            # its Request directly)
            raise ValueError("max_new_tokens must be >= 1")
        # numeric ranges: these land in packed int32 / uint32 buffers on the
        # engine thread, where an out-of-range value would raise mid-step
        # and stop the server; reject (or fold, for seed) them here
        prompt = [int(t) for t in prompt]
        V = self.model.config.vocab_size
        if any(t < 0 or t >= V for t in prompt):
            raise ValueError(f"prompt tokens must be in [0, {V})")
        if not (1 <= int(max_new_tokens) < 2**31):
            raise ValueError("max_new_tokens out of int32 range")
        if not (-2**31 <= int(top_k) < 2**31):
            raise ValueError("top_k out of int32 range")
        if not (-2**31 <= int(stop_token) < 2**31):
            raise ValueError("stop_token out of int32 range")
        temperature = float(temperature)
        if not np.isfinite(temperature):
            raise ValueError("temperature must be finite")
        top_p = float(top_p)
        if not (np.isfinite(top_p) and top_p > 0.0):
            raise ValueError("top_p must be finite and > 0")
        req = Request(
            id=next(self._ids), prompt=prompt,
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=int(top_k), top_p=top_p,
            seed=int(seed) & 0xFFFFFFFF,  # fold into uint32 (negatives ok)
            stop_token=int(stop_token),
            submitted_at=_time.perf_counter(),
        )
        self._live[req.id] = req
        self._queue.append(req)
        return req.id

    def prewarm(self) -> None:
        """Run every admission shape (both padded wave sizes x every prompt
        bucket) and the decode ticks once before taking traffic: the first
        calls build the kernels and let the CUDA libraries pick their
        algorithms. A server calls this once at start-up
        (cli/serve.py --prewarm=True)."""
        buckets, b = [], 8
        while b <= self.window:
            buckets.append(b)
            b *= 2
        if not buckets or buckets[-1] < self.window:
            buckets.append(self.window)  # non-power-of-two window bucket
        sizes = [1] + ([self.admit_group] if self.admit_group > 8 else [])
        for plen in buckets:
            for count in sizes:
                for _ in range(min(count, self.n_slots)):
                    self.submit([1] * plen, max_new_tokens=1,
                                temperature=0.0, top_k=1, seed=0)
                self.run_until_idle()
        self.reset_stats()  # prewarm pollutes phase/latency stats

    def _bucket(self, n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return min(p, self.cache_len)

    def _admit_wave(self, admits: list[tuple[int, Request, list[int], int]]):
        """Admit (slot, req, context, g0) entries in waves of G rows (8 when
        at most 8 wait, else ``admit_group``) at one prompt bucket, from ONE
        host-to-device upload."""
        packed, G = self._pack_admits(admits)
        self._insert_waves(packed, G, len(admits))

    def _pack_admits(self, admits) -> tuple[np.ndarray, int]:
        """The host side of :meth:`_admit_wave`: the slot table and the
        length mirror take the admissions; returns (the packed waves
        [n_waves * G, Pc + 10] int32, G)."""
        group = self.admit_group
        all_ctxs = [c[2][-self.window:] for c in admits]
        pc = self._bucket(max(len(c) for c in all_ctxs))
        G = 8 if len(admits) <= 8 else group
        n_waves = -(-len(admits) // G)
        packed = np.zeros((n_waves * G, pc + 10), np.int32)
        packed[:, -10] = self.n_slots  # padding rows
        packed[:, -9] = 1
        packed[:, -6] = -1
        packed[:, -2] = np.float32(1.0).view(np.int32)
        packed[:, -1] = np.float32(1.0).view(np.int32)
        for i, ((slot, req, _, g0_i), ctx) in enumerate(zip(admits, all_ctxs)):
            packed[i, :len(ctx)] = ctx
            packed[i, -10] = slot
            packed[i, -9] = len(ctx)
            packed[i, -8] = req.max_new_tokens
            packed[i, -7] = req.top_k
            packed[i, -6] = req.stop_token
            packed[i, -5] = g0_i
            packed[i, -4] = 1
            packed[i, -3] = np.uint32(req.seed).view(np.int32)
            packed[i, -2] = np.float32(req.top_p).view(np.int32)
            packed[i, -1] = np.float32(req.temperature).view(np.int32)
            self._slots[slot] = req
            self._lengths[slot] = len(ctx)
        return packed, G

    def _insert_waves(self, packed: np.ndarray, G: int, n: int) -> None:
        """The device side: ONE upload, then each wave's insert-prefill (on
        a mesh, the waves that hold rows of this rank's slots)."""
        n_waves = packed.shape[0] // G
        packed_dev = torch.from_numpy(
            packed.reshape(n_waves, G, -1)).to(self.device)
        for w in range(n_waves):
            n_valid, keep = min(G, n - w * G), None
            if self.link is not None:
                keep = self.link.mine(packed[w * G:w * G + n_valid, -10],
                                      self.device)
                if keep is None:
                    continue
            self.stats["admit_waves"] += 1
            self._insert_many(packed_dev[w], n_valid, keep)

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit queued requests, run one call of ticks, return the
        requests finished so far."""
        self.stats["steps"] += 1
        admits: list[tuple[int, Request, list[int], int]] = []

        # 0. apply pending cancellations (engine thread only, see cancel())
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            req = self._live.pop(rid, None)
            if req is None:
                continue
            if req in self._queue:
                self._queue.remove(req)
                continue
            for slot, r in enumerate(self._slots):
                if r is req:
                    # deactivate the device row: a zero-budget internal
                    # admit finishes on its first tick (gen 1 >= max_new 0),
                    # resetting its length and turning it inactive
                    dummy = Request(id=-1, prompt=[0], max_new_tokens=0,
                                    temperature=1.0, top_k=1, seed=0,
                                    stop_token=-1, internal=True)
                    admits.append((slot, dummy, dummy.prompt, 0))
                    self._slots[slot] = dummy
                    break

        # 1. fill free slots
        reserved = {slot for slot, *_ in admits}
        for slot in range(self.n_slots):
            if slot not in reserved and self._slots[slot] is None and self._queue:
                req = self._queue.popleft()
                admits.append((slot, req, req.prompt, 0))
                self._slots[slot] = req  # reserve; _pack_admits re-sets it

        if not admits and not any(r is not None for r in self._slots):
            return self._drain_finished()

        # 2. proactive window refresh: a slot must fit ticks_per_call more
        #    writes before its cache reaches cache_len (host-mirrored)
        reserved = {slot for slot, *_ in admits}
        for slot, req in enumerate(self._slots):
            if req is not None and slot not in reserved and (
                self._lengths[slot] + self.ticks_per_call > self.cache_len
            ):
                admits.append((slot, req, req.tokens, len(req.generated)))
        t0 = _time.perf_counter()
        packed, G = (self._pack_admits(admits) if admits
                     else (np.zeros((0, 1), np.int32), 0))
        if self.link is not None:  # the step's packet to every rank
            self.link.send(STEP, [packed], [G, len(admits)])
        if admits:
            self._insert_waves(packed, G, len(admits))
            self.stats["admit_s"] += _time.perf_counter() - t0

        # 3. decode: the ticks are enqueued, then one download waits for them
        t0 = _time.perf_counter()
        toks, emitted, done = self._gather(self._scan())
        self.stats["scan_s"] += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        if emitted is None:  # the packed uint16 fast path (one download)
            packed = toks.cpu().numpy().view(np.uint16)
            toks = (packed & 0x3FFF).astype(np.int32)
            emitted = (packed & 0x4000) != 0
            done = (packed & 0x8000) != 0
        else:
            toks, emitted, done = (x.cpu().numpy()
                                   for x in (toks, emitted, done))
        self.stats["fetch_s"] += _time.perf_counter() - t0

        # 4. demultiplex (vectorized per slot)
        t0 = _time.perf_counter()
        K = self.ticks_per_call
        done_tick = np.where(done.any(axis=0), done.argmax(axis=0), K)
        for slot, req in enumerate(self._slots):
            if req is None or req.done:
                continue
            # mirror the device's length update: +1 per tick the row was
            # active (the finishing tick still writes)
            self._lengths[slot] += int(min(done_tick[slot] + 1, K))
            if req.internal:  # slot-deactivation dummy: free silently
                if done_tick[slot] < K:
                    self._slots[slot] = None
                continue
            upto = done_tick[slot] + 1  # include the finishing token's tick
            col = emitted[:upto, slot]
            if col.any():
                req.generated.extend(toks[:upto, slot][col].tolist())
            if done_tick[slot] < K:
                req.done = True
                req.finished_at = _time.perf_counter()
                self._latencies.append(req.finished_at - req.submitted_at)
                self._live.pop(req.id, None)
                self._finished.append(req)
                self._slots[slot] = None
        self.stats["demux_s"] += _time.perf_counter() - t0
        return self._drain_finished()

    # -- sharded serving ------------------------------------------------------

    def _gather(self, outs):
        """On a mesh, the step's outputs over every slot (each data rank's
        rows); else as they are."""
        if self.link is None:
            return outs
        return tuple(None if t is None else self.link.gather(t, dim=1)
                     for t in outs)

    @torch.no_grad()
    def follow(self) -> None:
        """The loop of a rank other than 0 on a mesh: apply each step's
        packet to this rank's rows, run the ticks, send the tokens; returns
        at the stop packet (:meth:`shutdown`)."""
        if self.link is None or self.link.controller:
            raise RuntimeError("follow() is the loop of a rank other than 0 "
                               "of a mesh")
        while True:
            op, arrays, extra = self.link.recv()
            if op == STOP:
                return
            G, n = extra[0], extra[1]
            if n:
                self._insert_waves(arrays[0], G, n)
            self._gather(self._scan())

    def shutdown(self) -> None:
        """On a mesh, rank 0 sends the stop packet: every :meth:`follow`
        returns. Without a mesh, nothing."""
        if self.link is not None and self.link.controller:
            self.link.send(STOP)
