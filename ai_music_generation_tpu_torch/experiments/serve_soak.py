"""One long-lived GPT server under many load waves: the port of
``docs/experiments/serve_soak.py``.

    python -m ai_music_generation_tpu_torch.experiments.serve_soak \\
        [--waves=8] [--requests=2048] [--n_slots=1024] [--max_new=128] \\
        [--device=cuda]

One ``serve/engine.py::GenerationServer`` over the bench widths (6L/6H/384d,
block 256, vocab 128, MHA, int8 ring cache: K1's ring mode every tick) from
seeded init weights, ``prewarm``-ed (every admission shape and the ticks),
then ``--waves`` differently seeded loads of ``--requests`` (prompts of
4-48 tokens, ``max_new/2``-``max_new`` new tokens, T 0.8, top_k 64). What
a long-lived server must keep true, checked after every wave (the JAX
script's asserts, ``:75-88``):

- every submitted request finishes, with 1 to its budget of tokens;
- the engine's bookkeeping is empty between waves (``_slots``, ``_queue``,
  ``_live``, ``_cancelled``).

Per wave: tokens/s over the wave's wall, latency p50/p99 (submit to
finish), host RSS and ``torch.cuda.memory_allocated``; then the spread of
the warm waves' tokens/s ((max - min) / max over waves 1..) and each
memory's growth over the run. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os
import resource
import time

import numpy as np
import torch

from ai_music_generation_tpu_torch.experiments import decode_studies as ds

WIDTHS = dict(block_size=256, vocab_size=128, n_layer=6, n_head=6,
              n_embd=384)


def rss_mb() -> float:
    """The process's resident set now (Linux), else its peak."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**20
    except OSError:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def device_mb(device) -> float:
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 2**20


def load(srv, requests: int, max_new: int, vocab: int, seed: int) -> dict:
    """Submit one wave, drain it and check the accounting."""
    gen = np.random.default_rng(seed)
    ids = set()
    for i in range(requests):
        plen = int(gen.integers(4, 49))
        ids.add(srv.submit(
            gen.integers(1, vocab, size=plen).tolist(),
            max_new_tokens=int(gen.integers(max_new // 2, max_new + 1)),
            temperature=0.8, top_k=64, seed=i))
    t0 = time.perf_counter()
    with ds.StepCount() as counts:
        done = srv.run_until_idle()
    wall = time.perf_counter() - t0
    if len(done) != requests:
        raise AssertionError(f"{len(done)} of {requests} requests finished")
    toks = 0
    for r in done:
        if not 1 <= len(r.generated) <= r.max_new_tokens:
            raise AssertionError(f"request {r.id} emitted "
                                 f"{len(r.generated)} tokens of a budget "
                                 f"of {r.max_new_tokens}")
        if r.id not in ids:
            raise AssertionError(f"request {r.id} was not submitted")
        toks += len(r.generated)
    if srv.busy or any(s is not None for s in srv._slots):
        raise AssertionError("a slot leaked past the wave")
    if srv._queue or srv._live or srv._cancelled:
        raise AssertionError(
            f"bookkeeping left after the wave: queue {len(srv._queue)}, "
            f"live {len(srv._live)}, cancelled {len(srv._cancelled)}")
    return dict(tokens=toks, wall_s=wall, tok_s=toks / wall,
                counts=counts.as_dict())


def run(device: str = "cuda", waves: int = 8, requests: int = 2048,
        n_slots: int = 1024, max_new: int = 128, widths: dict = WIDTHS,
        seed: int = 0) -> dict:
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    cfg = GPTConfig(dropout=0.0, kv_quantized=True, dtype=torch.bfloat16,
                    **widths)
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    srv = GenerationServer(model, n_slots=n_slots,
                           ticks_per_call=min(64, cfg.block_size // 2),
                           admit_group=min(64, n_slots))
    t0 = time.perf_counter()
    srv.prewarm()
    ds.sync(device)
    prewarm_s = time.perf_counter() - t0
    base_rss, base_dev = rss_mb(), device_mb(device)
    rows = []
    for w in range(waves):
        srv.reset_stats()
        r = load(srv, requests, max_new, cfg.vocab_size,
                 seed + 1000 * (w + 1))
        r.update(srv.latency_stats(), wave=w,
                 rss_growth_mb=rss_mb() - base_rss,
                 device_growth_mb=device_mb(device) - base_dev)
        rows.append(r)
        print(f"wave {w}: {r['tok_s']:.1f} tok/s, wall {r['wall_s']:.2f} s, "
              f"p50 {r.get('p50_s')} s, p99 {r.get('p99_s')} s, rss "
              f"{r['rss_growth_mb']:+.1f} MB, device "
              f"{r['device_growth_mb']:+.1f} MB", flush=True)
    warm = [r["tok_s"] for r in rows[1:]] or [rows[0]["tok_s"]]
    return dict(study="serve_soak", device=device, waves=rows,
                requests=requests, n_slots=n_slots, max_new=max_new,
                prewarm_s=prewarm_s,
                warm_spread=(max(warm) - min(warm)) / max(warm),
                rss_growth_mb=rss_mb() - base_rss,
                device_growth_mb=device_mb(device) - base_dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--n_slots", type=int, default=1024)
    ap.add_argument("--max_new", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for key, value in WIDTHS.items():
        ap.add_argument(f"--{key}", type=int, default=value)
    args = ap.parse_args(argv)
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device).type
    return ds.print_result(run(
        device, args.waves, args.requests, args.n_slots, args.max_new,
        {k: getattr(args, k) for k in WIDTHS}))


if __name__ == "__main__":
    main()
