"""Per-step device time of the speculative verify step beside plain
decode: the port of ``docs/experiments/spec_trace.py``.

    python -m ai_music_generation_tpu_torch.experiments.spec_trace \\
        [--work_dir=studies_out] [--device=cuda] [--reuse]

On spec_decode's checkpoint (``decode_studies.spec_checkpoint``; trained
here unless ``--reuse`` finds it) with the int8 cache, at ``--batch``
(4096) x 8-token val-corpus slices, 500 new tokens, T 0.8, top_k 200:

- ``plain``: the plain ``Generator`` (K1 a layer a step);
- ``bf16``: ``SpecGenerator(n_draft=7)``, K2's bf16-dot verify;
- ``int8dots``: the same with ``spec_int8_dots`` (K2's int8 x int8 mode,
  ``spec_trace.py:163``).

Each variant: a warm-up generate, then one timed with CUDA events (ms a
generate over its steps: the plain generator's T=1 steps, the spec
generators' verify steps from ``generate_with_stats``), its K1 and K2
launches and, on the card, one more under
``torch.profiler``: the device kernels' time (self device time summed over
the entries whose device type is not the CPU) a step and the leading
kernels. The JAX script's XLA trace parsing is not ported.

Prints one JSON line.
"""

from __future__ import annotations

import argparse

import torch

from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments.spec_decode import (
    committed_per_step,
    val_prompts,
)

N_DRAFT = 7


def profiled(run, top: int = 8) -> dict:
    """Device time of ``run()`` under torch.profiler: the kernels' self
    device time summed (ms), their count and the ``top`` leading ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    return dict(device_ms=sum(r[0] for r in rows),
                kernels=sum(r[1] for r in rows),
                top=[dict(ms=ms, calls=n, name=key[:80])
                     for ms, n, key in rows[:top]])


def trace_one(gen, prompts, stats: bool, profile: bool) -> dict:
    timed = ds.timed_generate(gen, prompts, 1, seed=0, stats=stats)
    counts = timed["counts"][0]
    steps = timed["steps"][0] if stats else counts["t1_steps"]
    out = dict(ms=timed["ms"], tok_s=timed["tok_s"], steps=steps,
               ms_per_step=timed["ms"] / steps, counts=counts)
    if stats:
        out["committed_per_step"] = committed_per_step(timed, gen.window)[0]
    if profile:
        p = profiled(lambda: gen.generate(prompts(2), seed=2))
        out["profile"] = dict(p, device_ms_per_step=p["device_ms"] / steps)
    return out


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False, profile: bool = True) -> dict:
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    profile = profile and torch.device(device).type == "cuda"
    trained = ds.spec_checkpoint(work_dir, sizes, device, reuse)
    base = ds.variant(trained, kv_quantized=True)
    dots = ds.variant(trained, kv_quantized=True, spec_int8_dots=True)
    del trained["model"]
    ds.free(device)
    prompts = val_prompts(trained["dataset"], sizes.batch, 0)
    kw = dict(max_new_tokens=sizes.new, temperature=ds.TEMPERATURE,
              top_k=ds.TOP_K)
    result = dict(study="spec_trace", device=device,
                  train=ds.train_summary(trained))
    result["plain"] = trace_one(Generator(base, **kw), prompts, False,
                                profile)
    ds.free(device)
    for name, model in (("bf16", base), ("int8dots", dots)):
        result[f"{name}_k{N_DRAFT}"] = trace_one(
            SpecGenerator(model, n_draft=N_DRAFT, **kw), prompts, True,
            profile)
        ds.free(device)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes, args.device,
                               args.reuse))


if __name__ == "__main__":
    main()
