"""Speculative decoding on a trained model: the port of
``docs/experiments/spec_decode.py``.

    python -m ai_music_generation_tpu_torch.experiments.spec_decode \\
        [--work_dir=studies_out] [--device=cuda] [--reuse]

1. trains the bench widths (6L/6H/384d, block 256, MHA) on the repetitive
   corpus (2-5 unique measures a tune in repeated phrases; vocab padded to
   the bench's 128) at batch 64 for 1,500 iterations
   (``decode_studies.spec_checkpoint``);
2. times the plain int8-cache ``Generator`` (K1) against ``SpecGenerator``
   (K2 verify) at n_draft 4 and 8, ``--batch`` (4096) x 8-token
   val-corpus slices (fresh slices a generate, seeded), 500 new tokens, T
   0.8, top_k 200 (``decode_studies.timed_generate``);
3. reports the committed tokens per verify step from
   ``generate_with_stats``: (prompt + new - the prefill bucket) / steps.

The sampled distribution is the plain sampler's (rejection sampling), so
tokens/s is the axis. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ai_music_generation_tpu_torch.experiments import decode_studies as ds

DRAFTS = (4, 8)


def val_prompts(dataset: str, batch: int, seed: int):
    """``prompts(i)``: ``batch`` 8-token slices of val.bin at starts drawn
    from a generator seeded with ``seed + i`` (spec_decode.py:132-135)."""
    val = np.memmap(os.path.join(dataset, "val.bin"), dtype=np.uint16,
                    mode="r")

    def prompts(i):
        starts = np.random.default_rng(seed + i).integers(
            0, len(val) - ds.BENCH_PROMPT - 1, size=batch)
        return np.stack([val[s:s + ds.BENCH_PROMPT]
                         for s in starts]).astype(np.int32)

    return prompts


def committed_per_step(timed: dict, window: int) -> list[float]:
    """Each timed generate's committed tokens per verify step."""
    committed = (ds.BENCH_PROMPT + timed["new"]
                 - ds.prefill_bucket(ds.BENCH_PROMPT, window))
    return [committed / n for n in timed["steps"]]


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False) -> dict:
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    trained = ds.spec_checkpoint(work_dir, sizes, device, reuse)
    model = ds.variant(trained, kv_quantized=True)
    del trained["model"]
    ds.free(device)
    prompts = val_prompts(trained["dataset"], sizes.batch, 0)
    kw = dict(max_new_tokens=sizes.new, temperature=ds.TEMPERATURE,
              top_k=ds.TOP_K)
    plain = ds.timed_generate(Generator(model, **kw), prompts, sizes.reps,
                              seed=0)
    spec = {}
    for k in DRAFTS:
        gen = SpecGenerator(model, n_draft=k, **kw)
        spec[str(k)] = timed = ds.timed_generate(gen, prompts, sizes.reps,
                                                 seed=0, stats=True)
        timed["committed_per_step"] = committed_per_step(timed, gen.window)
        timed["speedup"] = timed["tok_s"] / plain["tok_s"]
        ds.free(device)
    return dict(study="spec_decode", device=device,
                train=ds.train_summary(trained), plain=plain, spec=spec)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes, args.device,
                               args.reuse))


if __name__ == "__main__":
    main()
