"""The decode-window contract, quality and throughput against the window:
the port of ``docs/experiments/window_quality.py``.

    python -m ai_music_generation_tpu_torch.experiments.window_quality \\
        [--work_dir=studies_out] [--device=cuda] [--reuse] \\
        [--windows=256,192,128] [--no-bench]

The model is spec_decode's (``decode_studies.spec_checkpoint``: the bench
widths, MHA, trained on the repetitive corpus into
``<work_dir>/ckpt_spec``), decoded in bf16 over the int8 cache, so every
T=1 step runs K1. For each window of ``--windows`` (the first is the
reference):

(a) 64 prompts of 48 tokens from the spec validation set at
    ``np.random.default_rng(7)`` offsets, 200 new tokens at T 0.8, top_k
    200, seed 42: each window's same-seed token agreement with the first
    window's, then the teacher NLL of the generated positions under the
    model (``decode_studies.teacher_nll``: the script's ``seq_nll``);
(b) the structural metrics of each set through the eval pipeline without
    WAVs (inner and conditioned similarities);
(c) tokens/s at ``--batch`` (4096) x 8-token random prompts, 500 new
    tokens (CUDA events after a warm-up of the same shape); ``--no-bench``
    skips it.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ai_music_generation_tpu_torch.experiments import decode_studies as ds

WINDOWS = (256, 192, 128)
PROMPT_SEED = 7  # the prompts' offsets (window_quality.py:62)


def val_prompts(dataset: str, n_gen: int, prompt: int) -> np.ndarray:
    """int32 [n_gen, prompt]: windows of the validation ids at
    ``default_rng(7)`` offsets (window_quality.py:60-64)."""
    val = np.memmap(os.path.join(dataset, "val.bin"), dtype=np.uint16,
                    mode="r")
    offs = np.random.default_rng(PROMPT_SEED).integers(
        0, len(val) - prompt, n_gen)
    return np.stack([np.asarray(val[o:o + prompt], np.int32) for o in offs])


def throughput(model, sizes: ds.Sizes, windows) -> dict:
    """Each window's tokens/s at the bench shape."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    out = {}
    for w in windows:
        gen = Generator(model, max_new_tokens=sizes.new,
                        temperature=ds.TEMPERATURE, top_k=ds.TOP_K, window=w)
        out[str(w)] = ds.timed_generate(
            gen, ds.random_prompts(model.config.vocab_size, sizes.batch, 0),
            sizes.reps, seed=0)
        ds.free(model.transformer.wte.weight.device)
    return out


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False, windows=WINDOWS, bench: bool = True) -> dict:
    trained = ds.spec_checkpoint(work_dir, sizes, device, reuse)
    model = ds.variant(trained, kv_quantized=True)
    del trained["model"]
    meta = ds.load_dataset_meta(trained["dataset"])
    prompts = val_prompts(trained["dataset"], sizes.n_gen, sizes.prompt)
    gens = {w: ds.quality_generations(model, prompts, sizes.gen_new, w)
            for w in windows}
    first = gens[windows[0]]
    result = dict(
        study="window_quality", device=device, windows=list(windows),
        train=ds.train_summary(trained), n_gen=len(prompts),
        agreement={str(w): ds.agreement(first, g, sizes.prompt)
                   for w, g in gens.items() if w != windows[0]},
        teacher_nll={str(w): ds.teacher_nll(model, g, sizes.prompt)
                     for w, g in gens.items()},
        structural={str(w): ds.structural_metrics(
            ds.write_abc(g, meta["itos"],
                         os.path.join(work_dir, f"win_abc_{w}")),
            os.path.join(work_dir, f"win_eval_{w}"), device)
            for w, g in gens.items()})
    if bench:
        result["throughput"] = throughput(model, sizes, windows)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    ap.add_argument("--windows", default=",".join(map(str, WINDOWS)),
                    help="decode windows, the reference first")
    ap.add_argument("--no-bench", dest="bench", action="store_false",
                    help="skip the throughput pass")
    args, sizes = ds.parse(ap, argv)
    windows = tuple(int(w) for w in args.windows.split(","))
    return ds.print_result(run(args.work_dir, sizes, args.device,
                               args.reuse, windows, args.bench))


if __name__ == "__main__":
    main()
