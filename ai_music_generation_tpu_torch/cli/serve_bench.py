"""Serving-throughput benchmark of the port's continuous-batching engine,
flag-compatible with ``ai_music_generation_tpu/cli/serve_bench.py
--engine gpt``:

    python -m ai_music_generation_tpu_torch.cli.serve_bench \\
        --n_slots=2048 --requests=4096 --max_new=256

Measures aggregate decode throughput (generated tokens / wall second) of
``serve.engine.GenerationServer`` under an open-loop load: ``--requests``
requests with prompts of 4-48 random tokens and budgets of max_new/2 to
max_new tokens (T 0.8, top_k 64), all submitted up front and admitted as
slots free. ONE long-lived server takes a cold pass with a differently
seeded load, then the timed pass. The wall clock of each pass ends after
``torch.cuda.synchronize()`` (the engine's last download already waits for
the card). Weights are random (``models/convert.py::init_weights`` from
``--seed``). Prints one JSON line: tok/s, the phase breakdown and the
latency percentiles.

``--engine tunes`` (the JAX ``bench_tunes`` protocol) measures tunes/min of
``serve.tunes_engine.TunesServer`` over the reference TunesFormer
(``TUNES_CONFIG``, ``TunesFormerConfig()``: 9+3 layers, 768 wide, 12
heads, bf16) with random weights
(``init_tunesformer_weights`` from ``--seed``): a warm pass of ``n_slots``
requests (seeds 10,000 + i), then ``--requests`` requests (seed i), every
one the prompt ``S:2 B:9 E:4 B:9 L:1/8 M:3/4 K:D de|`` at ``--max_patch``
(32) patches, top_p 0.8, top_k 8, T 1.2. One JSON line: tunes/min, the
latency percentiles and the step phases.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    init_weights,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
)
from ai_music_generation_tpu_torch.serve.engine import GenerationServer
from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer
from ai_music_generation_tpu_torch.utils.device import resolve_device


def submit_load(srv: GenerationServer, n: int, max_new: int,
                load_seed: int) -> None:
    """The mixed open-loop load: prompt lengths 4..48, budgets
    max_new/2..max_new, T 0.8, top_k 64, request i seeded i."""
    gen = np.random.default_rng(load_seed)
    vocab = srv.model.config.vocab_size
    for i in range(n):
        plen = int(gen.integers(4, 49))
        prompt = gen.integers(1, vocab, size=plen).tolist()
        srv.submit(prompt,
                   max_new_tokens=int(gen.integers(max_new // 2, max_new + 1)),
                   temperature=0.8, top_k=64, seed=i)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(srv: GenerationServer, n: int, max_new: int,
             load_seed: int) -> tuple[list, float]:
    """Submit one load and drive the server idle; (finished, wall s)."""
    submit_load(srv, n, max_new, load_seed)
    _sync(srv.device)
    t0 = time.perf_counter()
    finished = list(srv.run_until_idle())
    _sync(srv.device)
    return finished, time.perf_counter() - t0


TUNES_PROMPT = "S:2\nB:9\nE:4\nB:9\nL:1/8\nM:3/4\nK:D\n de|"
TUNES_CONFIG = TunesFormerConfig(dropout=0.0)


def run_tunes_pass(srv, n: int, max_patch: int,
                   seed0: int = 0) -> tuple[list, float]:
    """Submit ``n`` requests of the tunes protocol (seeds seed0 + i) and
    drive the server idle; (finished, wall s)."""
    for i in range(n):
        srv.submit(TUNES_PROMPT, max_patch=max_patch, seed=seed0 + i)
    _sync(srv.device)
    t0 = time.perf_counter()
    finished = list(srv.run_until_idle())
    _sync(srv.device)
    return finished, time.perf_counter() - t0


def bench_tunes(args, device) -> dict:
    """TunesFormer serving throughput (the reference-scale model)."""
    model = init_tunesformer_weights(
        TunesFormer(TUNES_CONFIG, device=device),
        torch.Generator(device=device).manual_seed(args.seed))
    srv = TunesServer(model.eval(), n_slots=args.n_slots)
    _, cold_wall = run_tunes_pass(srv, args.n_slots, args.max_patch, 10_000)
    srv.reset_stats()
    finished, wall = run_tunes_pass(srv, args.requests, args.max_patch)
    if len(finished) != args.requests:
        raise RuntimeError(f"{len(finished)} of {args.requests} requests "
                           "finished")
    result = {
        "metric": "tunesformer_serve_throughput",
        "value": round(len(finished) / wall * 60, 1),
        "unit": "tunes/min",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "requests": len(finished),
        "gen_chars": sum(len(r.text) - len(TUNES_PROMPT) for r in finished),
        "wall_s": round(wall, 2),
        "cold_wall_s": round(cold_wall, 2),
        "n_slots": args.n_slots,
        "max_patch": args.max_patch,
        "phases": {k: (round(v, 2) if isinstance(v, float) else v)
                   for k, v in srv.stats.items()},
        "latency": srv.latency_stats(),
    }
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=["gpt", "tunes"], default="gpt")
    ap.add_argument("--n_slots", type=int, default=2048)
    ap.add_argument("--ticks_per_call", type=int, default=64)
    ap.add_argument("--admit_group", type=int, default=64)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--max_new", type=int, default=256)
    ap.add_argument("--block_size", type=int, default=256)
    ap.add_argument("--vocab_size", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=6)
    ap.add_argument("--n_head", type=int, default=6)
    ap.add_argument("--n_embd", type=int, default=384)
    ap.add_argument("--max_patch", type=int, default=32,
                    help="tunes engine: patches per tune")
    ap.add_argument("--kv_quantized", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--n_kv_head", type=int, default=0,
                    help="GQA: KV heads (0 = n_head, MHA)")
    ap.add_argument("--flat_kv", action="store_true",
                    help="the JAX flat-cache flag (the port's cache is "
                    "always flat)")
    ap.add_argument("--cache_len", type=int, default=0,
                    help="ring-cache length; 0 = block_size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain twins: a run of "
                    "the code, not a measurement)")
    ap.add_argument("--seed", type=int, default=1337,
                    help="weights and the timed load; the cold load uses "
                    "seed + 1")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.engine == "tunes":
        return bench_tunes(args, device)

    cfg = GPTConfig(
        block_size=args.block_size, vocab_size=args.vocab_size,
        n_layer=args.n_layer, n_head=args.n_head, n_embd=args.n_embd,
        dropout=0.0, kv_quantized=args.kv_quantized,
        n_kv_head=args.n_kv_head or None, flat_kv=args.flat_kv)
    model = init_weights(GPT(cfg, device=device),
                         torch.Generator(device=device).manual_seed(args.seed))
    srv = GenerationServer(
        model.eval(), n_slots=args.n_slots,
        ticks_per_call=args.ticks_per_call, admit_group=args.admit_group,
        cache_len=args.cache_len or None)
    _, cold_wall = run_pass(srv, args.requests, args.max_new, args.seed + 1)
    srv.reset_stats()
    finished, wall = run_pass(srv, args.requests, args.max_new, args.seed)
    if len(finished) != args.requests:
        raise RuntimeError(f"{len(finished)} of {args.requests} requests "
                           "finished")
    gen_tokens = sum(len(r.generated) for r in finished)
    result = {
        "metric": "serve_decode_throughput",
        "value": round(gen_tokens / wall, 1),
        "unit": "tok/s",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "requests": len(finished),
        "gen_tokens": gen_tokens,
        "wall_s": round(wall, 2),
        "cold_wall_s": round(cold_wall, 2),
        "n_slots": args.n_slots,
        "ticks_per_call": args.ticks_per_call,
        "admit_group": args.admit_group,
        "kv_quantized": args.kv_quantized,
        "n_kv_head": args.n_kv_head or args.n_head,
        "flat_kv": args.flat_kv,
        "cache_len": srv.cache_len,
        "phases": {k: (round(v, 2) if isinstance(v, float) else v)
                   for k, v in srv.stats.items()},
        "latency": srv.latency_stats(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
