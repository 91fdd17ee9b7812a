"""The real path at window 128 on the KH=2 flagship: the port of
``docs/experiments/realpath_window_r5.py``.

    python -m ai_music_generation_tpu_torch.experiments.realpath_window_r5 \\
        [--work_dir=studies_out] [--device=cuda] [--reuse] [--window=128]

What a user gets from ``cli/sample.py --window=128``: the protocol of
``realpath_bench_r5`` (4 conditioning measures, 500 new tokens, T 0.8,
top_k 200, ``--kv_quantized --flat_kv``, one sample a validation entry)
with the decode window cut to 128, at each ``--samples`` leg, a cold pass
at seed 1337 and a warm one at 1338, on the flagship's ``ckpt.pt``
(trained here unless ``--reuse`` finds it in ``--work_dir``). Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import os

from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments.realpath_bench_r5 import (
    cli_legs,
)


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False, window: int = 128) -> dict:
    trained = ds.measure_random_checkpoint(work_dir, sizes, device, reuse,
                                           n_kv_head=2)
    del trained["model"]
    ds.free(device)
    legs = cli_legs(trained, os.path.join(work_dir, "ckpt_kh2"), sizes,
                    device, window)
    return dict(study="realpath_window_r5", device=device, window=window,
                train=ds.train_summary(trained), cli=legs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    ap.add_argument("--window", type=int, default=128)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes,
                               args.device, args.reuse, args.window))


if __name__ == "__main__":
    main()
