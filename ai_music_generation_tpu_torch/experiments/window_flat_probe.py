"""The decode window composed with the flat KH=2 cache, and the MHA int8
cache at the full window: the port of
``docs/experiments/window_flat_probe.py``.

    python -m ai_music_generation_tpu_torch.experiments.window_flat_probe \\
        [--device=cuda] [--windows=256,192,128]

Throughput only, at bench.py's protocol: the bench widths (6L/6H/384d,
block 256, vocab 128, bf16, int8 cache) from seeded init weights
(``window64_probe.bench_model``), ``--batch`` (4096) x 8-token random
prompts, 500 new tokens, T 0.8, top_k 200; a warm-up, then ``--reps`` (3)
generates timed with CUDA events (``decode_studies.timed_generate``). The
configurations (:data:`CONFIGS`, the script's ``:41-45``):

- the flagship, KH=2 with the flat cache, at each window of ``--windows``;
- MHA (KH=6) at the full window (``block_size``).

Both run K1 on every T=1 step. Prints one JSON row a (configuration,
window), then the closing ``{"all": [...]}`` line with the rest of the
result.
"""

from __future__ import annotations

import argparse
import json

from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments.window64_probe import (
    bench_model,
)

# (label, the model's cache layout, windows: None = the flagship's
# --windows, else the full window)
CONFIGS = (
    ("flagship KH=2 flat", dict(n_kv_head=2, flat_kv=True), None),
    ("MHA KH=6 einsum", dict(n_kv_head=None, flat_kv=False), "full"),
)
WINDOWS = (256, 192, 128)


def run(sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        windows=WINDOWS) -> dict:
    from ai_music_generation_tpu_torch.decode.generate import Generator

    rows = []
    for label, layout, which in CONFIGS:
        model = bench_model(sizes, device, **layout)
        for w in windows if which is None else (sizes.block_size,):
            gen = Generator(model, max_new_tokens=sizes.new,
                            temperature=ds.TEMPERATURE, top_k=ds.TOP_K,
                            window=w)
            t = ds.timed_generate(
                gen, ds.random_prompts(ds.BENCH_VOCAB, sizes.batch, 0),
                sizes.reps, seed=0)
            row = dict(config=label, window=w, tok_s=t["tok_s"],
                       s_per_call=t["ms"] / 1000, counts=t["counts"])
            rows.append(row)
            print(json.dumps(row), flush=True)
        del model
        ds.free(device)
    return {"all": rows, "study": "window_flat_probe", "device": device,
            "batch": sizes.batch, "new": sizes.new, "reps": sizes.reps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap, trains=False)
    ap.add_argument("--windows", default=",".join(map(str, WINDOWS)),
                    help="the flagship's decode windows")
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(
        sizes, args.device, tuple(int(w) for w in args.windows.split(","))))


if __name__ == "__main__":
    main()
