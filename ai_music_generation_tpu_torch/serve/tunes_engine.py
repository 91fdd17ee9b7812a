"""Continuous-batching TunesFormer server: the port of
``ai_music_generation_tpu/serve/tunes_engine.py``.

Requests with different prompts, sampling settings and arrival times share
the fixed ``n_slots`` rows of one bar step and enter and leave slots as
they finish:

- the patch-core cache is a per-row ring (``KVCache.create(...,
  per_row=True)``, max_len = patch_length): a slot's committed patches sit
  as K/V columns at its own positions, and each bar feeds only every
  slot's newest patch through ``TunesFormer.patch_step``; idle rows keep
  their length (a row whose request filled all patch_length positions sits
  at length patch_length, a position clipped as JAX's gather clips);
- admission is an insert-prefill: the admitted prompts' patch stacks (at
  most ``admit_group`` a step) are prefilled as one batch on a lockstep
  cache, each row rolled so its first ``n_patches - 1`` patches end at the
  ring cursor, and scattered into its slot (the newest prompt patch is the
  slot's first feed, so every bar runs the same one-position step);
- each bar: one ``patch_step`` for every slot (lengths of inactive slots
  pinned), then the char scan (``decode/tunes_generate.py::
  char_bar_scan``) with per-row ``top_p`` / ``top_k`` / ``temperature``;
  one upload of the bar's host inputs, one download of its chars;
- the host demultiplexes: eos patch, empty bar and ``max_patch`` stop
  rules and S:/B:/E: filtering as the batch generator.

On the card every cached step runs K1 once per layer: ``patch_layers +
patch_size * char_layers`` launches a bar.

RNG contract. JAX samples char ``j`` of bar ``i`` of a request with seed
``s`` from ``fold_in(fold_in(PRNGKey(s), i), j)``, which torch cannot
reproduce. The port keeps the contract with a counter hash: the draw is an
exponential race over the filtered probabilities (argmax of p / E) with

    row  = mix(mix(mix(s ^ 0x243F6A88) ^ i) ^ j)
    bits = mix(row ^ (r * 0x9E3779B1 mod 2^32))        for sorted rank r
    u    = (2 * (bits >> 9) + 1) / 2^24,   E = -log(u)

(``mix`` = murmur3's finalizer, ``utils/hash32.py``): integer ops on int64,
the same bits on the CPU and the card. A request's tune therefore depends
only on its own fields, never on its slot or on other traffic (up to the
floating-point differences of another number of requests admitted in the
same step: the prefill's batch is the wave).

Sharded serving (``mesh=``, JAX :133-183): every process of a (data,
model) ``DeviceMesh`` builds the server (``serve/mesh.py``'s control
plane, rank 0 serving, the others in :meth:`TunesServer.follow`). The
parameters take the tensor-parallel layout of ``models/tunesformer.py``
(``parallel/sharding.py::parallelize``, no FSDP), its patch and char steps
running the rank's heads over caches of its K/V heads. The patch cache
rides the data axis when ``n_slots % n_data == 0``: each data rank runs
the bar of its rows; otherwise every data rank runs all the rows, as JAX
replicates them. Each step's packet is the admission upload and the bar's
upload; every rank prefills the whole admission wave and scatters the
rows of its slots.
"""

from __future__ import annotations

import dataclasses
import itertools
import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ai_music_generation_tpu_torch.decode.tunes_generate import (
    char_bar_scan,
    draw,
    filter_control_codes,
    filter_generated_bar,
    filter_sorted,
    prepare_patch_state,
)
from ai_music_generation_tpu_torch.models.gpt import KVCache
from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
from ai_music_generation_tpu_torch.serve.engine import EngineHostBase
from ai_music_generation_tpu_torch.serve.mesh import STOP, STEP, MeshLink
from ai_music_generation_tpu_torch.tokenizers.patchilizer import Patchilizer
from ai_music_generation_tpu_torch.utils.hash32 import GOLDEN, M32, mix32, mul32


def tunes_noise_bits(seed: torch.Tensor, bar: torch.Tensor,
                     idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """The 32 random bits of each (row, sorted rank), int64 [B, V]: a
    function of (seed[b], bar[b], idx[b], r) only (module docstring).
    ``seed`` holds uint32 values; ``bar`` and ``idx`` are counts."""
    seed = seed.to(torch.int64) & M32
    row = mix32(mix32(mix32(seed ^ 0x243F6A88) ^ (bar.to(torch.int64) & M32))
                ^ (idx.to(torch.int64) & M32))
    r = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    return mix32(row[:, None] ^ mul32(r, GOLDEN)[None, :])


def sample_ptk_vec(probs: torch.Tensor, seed: torch.Tensor,
                   bar: torch.Tensor, idx: torch.Tensor, top_p: torch.Tensor,
                   top_k: torch.Tensor,
                   temperature: torch.Tensor) -> torch.Tensor:
    """Per-row nucleus -> top-k -> temperature sampling, the [B]-vector
    form of ``sample_top_p_top_k_temperature`` (``top_k <= 0``: no top-k;
    the temperature acts as p^(1/max(T, 1e-6))), drawn with the row's
    counter noise of (seed, bar, idx). [B] int32."""
    V = probs.shape[-1]
    eff_k = torch.where(top_k > 0, top_k, V)
    inv_t = 1.0 / temperature.clamp_min(1e-6)
    filtered, sorted_idx = filter_sorted(probs, top_p[:, None],
                                         eff_k[:, None], inv_t[:, None])
    u = ((tunes_noise_bits(seed, bar, idx, V) >> 9) * 2 + 1).to(
        torch.float32) * 2.0 ** -24
    return draw(filtered, sorted_idx, -torch.log(u))


@dataclasses.dataclass(eq=False)  # identity equality for safe queue removal
class TuneRequest:
    id: int
    prompt: str
    max_patch: int
    top_p: float
    top_k: int
    temperature: float
    seed: int
    show_control_code: bool
    text: str = ""  # visible output (prompt + generated bars)
    done: bool = False
    submitted_at: float = 0.0  # perf_counter at submit()
    finished_at: float = 0.0


class _SlotState:
    """Host-side per-slot patch bookkeeping (mirrors generate_tunes)."""

    def __init__(self, req: TuneRequest, patchilizer: Patchilizer,
                 L: int, S: int):
        self.req = req
        prompt_patches, self.carried = prepare_patch_state(
            patchilizer, req.prompt, L, S)
        self.patches = np.zeros((L, S), np.int32)
        self.patches[: len(prompt_patches)] = np.asarray(prompt_patches,
                                                         np.int32)
        self.n_patches = len(prompt_patches)
        self.bars = 0  # the RNG's bar index


class TunesServer(EngineHostBase):
    """Continuous-batching TunesFormer server over a :class:`TunesFormer`
    (its weights and device are the model's).

    Usage::

        srv = TunesServer(model, n_slots=16)
        rid = srv.submit("S:2\\nB:9\\n...", max_patch=64, seed=7)
        for req in srv.run_until_idle():
            print(req.id, req.text)

    ``mesh``: a (data, model) ``DeviceMesh`` over every process (module
    docstring); every rank builds the server over the same whole model,
    which it splits in place; rank 0 serves and the others call
    :meth:`follow`.
    """

    def __init__(self, model: TunesFormer, n_slots: int = 16, mesh=None,
                 admit_group: int = 256):
        self.model = model
        self.cfg = model.config
        self.device = model.device
        self.n_slots = n_slots
        # admissions per step are capped: the insert-prefill of n requests
        # holds a transient [n, L] patch cache and the [n, L, S, C]
        # embedding gather
        self.admit_group = min(admit_group, n_slots)
        self.patchilizer = Patchilizer()
        self._queue: deque[TuneRequest] = deque()
        self._slots: list[Optional[_SlotState]] = [None] * n_slots
        self._ids = itertools.count()
        self._finished: deque[TuneRequest] = deque()
        self._latencies: deque = deque(maxlen=10_000)
        # cancellation registry: producer threads only touch these
        self._live: dict[int, TuneRequest] = {}
        self._cancelled: set[int] = set()
        # host wall time per step phase: admit_s the admission's packing,
        # bar_s the insert-prefill's and the bar's enqueue, fetch_s the wait
        # for its chars
        self.stats = {"steps": 0, "admit_waves": 0, "admit_s": 0.0,
                      "bar_s": 0.0, "fetch_s": 0.0, "demux_s": 0.0}
        self.link, rows, heads = None, n_slots, (None, None)
        if mesh is not None:
            from ai_music_generation_tpu_torch.parallel.sharding import (
                parallelize,
            )

            self.link = MeshLink(mesh, n_slots, even=False)
            rows = self.link.rows
            parallelize(model, self.link.layout, data_parallel=False)
            heads = tuple(core.h[0].attn.cache_heads()
                          for core in (model.patch_core, model.char_core))
        self._patch_heads = heads[0]
        self._patch_cache = KVCache.create(
            self.cfg.patch_core_config(), rows,
            max_len=self.cfg.patch_length, device=self.device, per_row=True,
            kv_heads=heads[0])
        self._char_cache = KVCache.create(
            self.cfg.char_core_config(), rows,
            max_len=self.cfg.patch_size, device=self.device,
            kv_heads=heads[1])

    # -- device work --------------------------------------------------------

    def _pack_admitted(self, admitted: list[tuple[int, _SlotState]]
                       ) -> np.ndarray:
        """The wave's upload [n, L*S + 2] int32: each admitted patch stack,
        its slot and its ``plen``."""
        L, S = self.cfg.patch_length, self.cfg.patch_size
        packed = np.zeros((len(admitted), L * S + 2), np.int32)
        for i, (slot, st) in enumerate(admitted):
            packed[i, :L * S] = st.patches.reshape(-1)
            packed[i, -2] = slot
            packed[i, -1] = max(st.n_patches, 1) - 1
        return packed

    def _admit(self, packed: np.ndarray) -> None:
        """Insert-prefill one wave (:meth:`_pack_admitted`): the n admitted
        patch stacks as n rows on a lockstep cache, each rolled so its first
        ``plen = n_patches - 1`` patches end at the ring cursor, and
        scattered into its slot; its length becomes plen. On a mesh the
        whole wave is prefilled and the rows of this rank's slots
        scattered."""
        L, S = self.cfg.patch_length, self.cfg.patch_size
        n = packed.shape[0]
        dev = torch.from_numpy(packed).to(self.device)
        rows = dev[:, :L * S].reshape(n, L, S)
        mine = slice(None)
        if self.link is not None:
            mine = self.link.mine(packed[:, -2], self.device)
            if mine is None:
                return
        slots, plens = dev[mine, -2].long(), dev[mine, -1]
        if self.link is not None:
            slots = slots - self.link.base
        pre = KVCache.create(self.cfg.patch_core_config(), n, max_len=L,
                             device=self.device, kv_heads=self._patch_heads)
        self.model.encode_patches_cached(rows, pre)
        cache = self._patch_cache
        # the prefill wrote prompt patch p at column p; the ring expects it
        # at (cursor - plen + p) mod L
        shifts = (cache.cursor - plens) % L
        src = (torch.arange(L, device=self.device)[None, :]
               - shifts[:, None]) % L  # rolled[j] = pre[src[j]]
        for bufs, new in ((cache.k, pre.k), (cache.v, pre.v)):
            for buf, p in zip(bufs, new):
                idx = src[:, :, None].expand(-1, -1, p.shape[2])
                buf[slots] = torch.gather(p[mine], 1, idx)
        cache.length[slots] = plens

    def _bar(self, packed: np.ndarray):
        """One bar for every slot from the packed host inputs (layout in
        :meth:`step`): a ring ``patch_step`` (inactive rows' lengths pinned)
        and the char scan with per-row sampling. Returns (tokens [B, S],
        lens [B]) on the device."""
        S = self.cfg.patch_size
        dev = torch.from_numpy(packed).to(self.device)
        init_tokens, feed = dev[:, :S], dev[:, S:2 * S]
        active = dev[:, 2 * S] != 0
        init_lens, bar_idx, top_k = (dev[:, 2 * S + i] for i in (1, 2, 3))
        seeds = dev[:, 2 * S + 4].long() & M32
        top_p = dev[:, 2 * S + 5].contiguous().view(torch.float32)
        temperature = dev[:, 2 * S + 6].contiguous().view(torch.float32)
        cache = self._patch_cache
        before = cache.length.clone()
        last, _ = self.model.patch_step(feed, cache)
        cache.length.copy_(torch.where(active, cache.length, before))

        def sample_fn(probs, j):
            return sample_ptk_vec(probs, seeds, bar_idx,
                                  (j - init_lens).clamp_min(0), top_p, top_k,
                                  temperature)

        return char_bar_scan(self.model, last, init_tokens, init_lens,
                             sample_fn, self._char_cache)

    # -- host orchestration --------------------------------------------------

    def prewarm(self) -> None:
        """Run one short tune before taking traffic: the first calls build
        the kernels and let the CUDA libraries pick their algorithms."""
        self.submit("K:C\nC|", max_patch=2, seed=0)
        self.run_until_idle()
        self.reset_stats()

    def submit(self, prompt: str, max_patch: int = 128, top_p: float = 0.8,
               top_k: int = 8, temperature: float = 1.2, seed: int = 0,
               show_control_code: bool = True) -> int:
        """Queue a request; returns its id. Safe for producer threads beside
        one engine thread."""
        if not prompt:
            raise ValueError("prompt must be non-empty")
        # these land in packed int32 buffers on the engine thread, where an
        # out-of-range value would raise mid-step and stop the server
        if not (1 <= int(max_patch) < 2**31):
            raise ValueError("max_patch must be >= 1 (and fit int32)")
        if not (-2**31 <= int(top_k) < 2**31):
            raise ValueError("top_k out of int32 range")
        top_p, temperature = float(top_p), float(temperature)
        if not (np.isfinite(top_p) and np.isfinite(temperature)):
            raise ValueError("top_p/temperature must be finite")
        req = TuneRequest(
            id=next(self._ids), prompt=str(prompt), max_patch=int(max_patch),
            top_p=top_p, top_k=int(top_k), temperature=temperature,
            seed=int(seed) & 0xFFFFFFFF,  # fold into uint32 (negatives ok)
            show_control_code=bool(show_control_code),
            submitted_at=_time.perf_counter())
        self._live[req.id] = req
        self._queue.append(req)
        return req.id

    @torch.inference_mode()
    def step(self) -> list[TuneRequest]:
        """Admit queued requests, run one bar, demultiplex; returns the
        requests finished so far."""
        L, S = self.cfg.patch_length, self.cfg.patch_size
        self.stats["steps"] += 1
        # apply pending cancellations (engine thread only): admission is
        # re-done for a slot's next request, so a cancelled slot just frees
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            req = self._live.pop(rid, None)
            if req is None:
                continue
            if req in self._queue:
                self._queue.remove(req)
                continue
            for slot, st in enumerate(self._slots):
                if st is not None and st.req is req:
                    self._slots[slot] = None
                    break
        admitted: list[tuple[int, _SlotState]] = []
        for slot in range(self.n_slots):
            if len(admitted) >= self.admit_group or not self._queue:
                break
            if self._slots[slot] is None:
                req = self._queue.popleft()
                st = _SlotState(req, self.patchilizer, L, S)
                req.text = filter_control_codes(req.prompt,
                                                req.show_control_code)
                self._slots[slot] = st
                admitted.append((slot, st))
        if not any(s is not None for s in self._slots):
            return self._drain_finished()
        t0 = _time.perf_counter()
        adm = self._pack_admitted(admitted)
        if admitted:
            self.stats["admit_waves"] += 1
        t1 = _time.perf_counter()

        # one [B, 2S+7] int32 upload: [0:S] init tokens (bos + carried),
        # [S:2S] the feed (each slot's newest committed patch), then active,
        # init_lens (>= 1), the bar index, top_k, seed (u32 bits), top_p and
        # temperature (f32 bits)
        B = self.n_slots
        packed = np.zeros((B, 2 * S + 7), np.int32)
        packed[:, 0] = Patchilizer.bos_token_id
        packed[:, 2 * S + 1] = 1
        packed[:, 2 * S + 5] = np.float32(1.0).view(np.int32)
        packed[:, 2 * S + 6] = np.float32(1.0).view(np.int32)
        for b, st in enumerate(self._slots):
            if st is None:
                continue
            # the device length is n_patches - 1 on every bar, so the feed
            # lands at its true position
            packed[b, S:2 * S] = st.patches[max(st.n_patches, 1) - 1]
            packed[b, 2 * S] = 1
            # at most S-2 carried chars, so one can still be sampled
            chars = [ord(c) for c in st.carried][: S - 2]
            packed[b, 1:1 + len(chars)] = chars
            packed[b, 2 * S + 1] = 1 + len(chars)
            packed[b, 2 * S + 2] = st.bars
            packed[b, 2 * S + 3] = st.req.top_k
            packed[b, 2 * S + 4] = np.uint32(st.req.seed).view(np.int32)
            packed[b, 2 * S + 5] = np.float32(st.req.top_p).view(np.int32)
            packed[b, 2 * S + 6] = np.float32(
                st.req.temperature).view(np.int32)
        if self.link is not None:  # the step's packet to every rank
            self.link.send(STEP, [adm, packed])
        out = self._device_step(adm, packed)
        t2 = _time.perf_counter()
        out = out.cpu().numpy()
        t3 = _time.perf_counter()
        tokens, lens = out[:, :S], out[:, S]
        init_lens = packed[:, 2 * S + 1]

        p = self.patchilizer
        for b, st in enumerate(self._slots):
            if st is None:
                continue
            req = st.req
            st.bars += 1
            new_tokens = tokens[b, init_lens[b]:lens[b]]
            finish = False
            if st.n_patches >= min(req.max_patch, L):
                finish = True
            elif len(new_tokens) and \
                    new_tokens[0] == Patchilizer.eos_token_id:
                finish = True
            else:
                bar = p.patch2bar(new_tokens)
                if bar == "":
                    finish = True
                else:
                    req.text += filter_generated_bar(
                        bar, req.show_control_code)
                    st.patches[st.n_patches] = p.bar2patch(
                        st.carried + bar, S)  # the next bar's feed
                    st.carried = ""
                    st.n_patches += 1
                    if st.n_patches >= min(req.max_patch, L):
                        finish = True
            if finish:
                req.done = True
                req.finished_at = _time.perf_counter()
                self._latencies.append(req.finished_at - req.submitted_at)
                self._live.pop(req.id, None)
                self._finished.append(req)
                self._slots[b] = None
        self.stats["admit_s"] += t1 - t0
        self.stats["bar_s"] += t2 - t1
        self.stats["fetch_s"] += t3 - t2
        self.stats["demux_s"] += _time.perf_counter() - t3
        return self._drain_finished()

    def _device_step(self, adm: np.ndarray, packed: np.ndarray):
        """Admit the wave ``adm``, run the bar of ``packed`` (every slot's
        row; on a mesh this rank's rows of it); returns [n_slots, S + 1]
        (the bar's tokens, then its length) on the device (on a mesh,
        gathered over the data axis)."""
        if adm.shape[0]:
            self._admit(adm)
        if self.link is not None:
            packed = packed[self.link.base:self.link.base + self.link.rows]
        tokens, lens = self._bar(packed)
        out = torch.cat([tokens, lens[:, None]], dim=1)
        return out if self.link is None else self.link.gather(out, dim=0)

    @torch.inference_mode()
    def follow(self) -> None:
        """The loop of a rank other than 0 on a mesh: apply each step's
        packet (admission, then the bar of this rank's rows), send the
        chars; returns at the stop packet (:meth:`shutdown`)."""
        if self.link is None or self.link.controller:
            raise RuntimeError("follow() is the loop of a rank other than 0 "
                               "of a mesh")
        while True:
            op, arrays, _ = self.link.recv()
            if op == STOP:
                return
            self._device_step(*arrays)

    def shutdown(self) -> None:
        """On a mesh, rank 0 sends the stop packet: every :meth:`follow`
        returns. Without a mesh, nothing."""
        if self.link is not None and self.link.controller:
            self.link.send(STOP)
