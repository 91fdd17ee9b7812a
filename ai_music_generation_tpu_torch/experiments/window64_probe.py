"""Window 64 at the bench protocol and on the trained flagship: the port
of ``docs/experiments/window64_probe.py``.

    python -m ai_music_generation_tpu_torch.experiments.window64_probe \\
        [--work_dir=studies_out] [--device=cuda] [--reuse] [--window=64]

(a) throughput at bench.py's protocol at window 64: the bench config
    (6L/6H/384d, block 256, vocab 128, bf16, int8 flat cache, KH=2) from
    seeded init weights, ``Generator(window=64)`` at ``--batch`` (4096) x
    8-token random prompts, 500 new tokens, T 0.8, top_k 200
    (``decode_studies.timed_generate``); a refresh every 32 tokens;
(b) quality on the flagship's ``ckpt.pt`` (trained here unless ``--reuse``
    finds it): 64 conditioned 200-token generations at seed 42 at window
    64 and at the full window (the realpath_bench_r5 method): same-seed
    token agreement and the teacher NLL of each.

Prints one JSON line.
"""

from __future__ import annotations

import argparse

import torch

from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments.realpath_bench_r5 import (
    window_quality,
)


def bench_model(sizes: ds.Sizes, device: str, seed: int = 0,
                n_kv_head=2, flat_kv=True):
    """The bench config (bench.py:60-65) at ``sizes``' widths from seeded
    init weights (``n_kv_head=None, flat_kv=False``: its MHA twin)."""
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=ds.BENCH_VOCAB, dropout=0.0, bias=False,
                    dtype=torch.bfloat16, kv_quantized=True,
                    n_kv_head=n_kv_head, flat_kv=flat_kv, **sizes.arch)
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False, window: int = 64) -> dict:
    from ai_music_generation_tpu_torch.decode.generate import Generator

    model = bench_model(sizes, device)
    gen = Generator(model, max_new_tokens=sizes.new,
                    temperature=ds.TEMPERATURE, top_k=ds.TOP_K, window=window)
    speed = ds.timed_generate(
        gen, ds.random_prompts(ds.BENCH_VOCAB, sizes.batch, 0), sizes.reps,
        seed=0)
    del gen, model
    ds.free(device)
    trained = ds.measure_random_checkpoint(work_dir, sizes, device, reuse,
                                           n_kv_head=2)
    del trained["model"]
    ds.free(device)
    quality = window_quality(trained, ds.load_flagship(work_dir, device),
                             sizes, (sizes.block_size, window))
    return dict(study="window64_probe", device=device, window=window,
                throughput=speed, train=ds.train_summary(trained),
                quality=quality)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    ap.add_argument("--window", type=int, default=64)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes,
                               args.device, args.reuse, args.window))


if __name__ == "__main__":
    main()
