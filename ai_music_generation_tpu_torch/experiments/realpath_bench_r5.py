"""The real-path protocol on the KH=2 flagship: the port of
``docs/experiments/realpath_bench_r5.py``.

    python -m ai_music_generation_tpu_torch.experiments.realpath_bench_r5 \\
        [--work_dir=studies_out] [--device=cuda] [--reuse]

1. trains the flagship (the bench config: 6L/6H/384d, block 256, GQA
   ``n_kv_head=2``; batch 32, 1,500 iterations, ``:73-90``) on the
   measure-random corpus, laid out as the irishman char dataset
   (``decode_studies.measure_random_checkpoint``);
2. runs the user path, ``cli/sample.py``'s ``main`` with ``--kv_quantized
   --flat_kv`` (``:95-130``): 4 conditioning measures, 500 new tokens, T
   0.8, top_k 200 (``--new`` tokens), one sample a validation entry, at
   each ``--samples``
   leg (1,000 at batch 1,000, then 4,096 at batch 4,096), a cold pass at
   seed 1337 then a warm one at 1338, each timed on the host clock over
   the whole run (tokenize, decode, normalization, file writes);
3. the microbench on the same weights (its ``ckpt.pt``, int8 flat cache):
   ``Generator`` (full window) at
   ``--batch`` (4096) x 8-token random prompts, 500 new tokens
   (``decode_studies.timed_generate``);
4. the window-quality re-measure (``:163-193``): 64 conditioned 200-token
   generations at seed 42 at window 128 and at the full window, their
   same-seed token agreement and the teacher NLL of each under the model.

Prints one JSON line. Every forward at T=1 runs K1; each run's counts of
K1 launches and T=1 steps are in the result.
"""

from __future__ import annotations

import argparse
import os
import time

from ai_music_generation_tpu_torch.experiments import decode_studies as ds


def run_cli(out_dir: str, data_root: str, validation: str, n: int,
            new: int, seed: int, device: str, window: int = 0) -> dict:
    """One ``cli/sample.py`` run of the protocol (``n`` samples at batch
    ``n``, ``new`` tokens each): its host wall, samples/s, tokens/s and
    counts."""
    from ai_music_generation_tpu_torch.cli import sample as sample_cli

    argv = [f"--out_dir={out_dir}", f"--data_root={data_root}",
            f"--dataset={ds.DATASET}", "--tokens_format=char",
            f"--validation_path={validation}", "--n_conditional_measures=4",
            f"--num_samples={n}", f"--max_new_tokens={new}",
            f"--temperature={ds.TEMPERATURE}", f"--top_k={ds.TOP_K}",
            f"--seed={seed}", f"--batch_size={n}", "--kv_quantized=True",
            "--flat_kv=True", f"--window={window}", f"--device={device}"]
    t0 = time.perf_counter()
    with ds.StepCount() as counts:
        results = sample_cli.main(argv)
    wall = time.perf_counter() - t0
    if len(results) != n:
        raise AssertionError(f"the sampler wrote {len(results)} samples, "
                             f"not {n}")
    return dict(samples=n, wall_s=wall, samples_s=n / wall,
                tok_s=n * new / wall, counts=counts.as_dict())


def cli_legs(trained: dict, out_dir: str, sizes: ds.Sizes, device: str,
             window: int = 0) -> list[dict]:
    """Each ``sizes.samples`` leg, cold then warm."""
    data_root = os.path.dirname(trained["dataset"])
    val = trained["tunes"][ds.n_train(len(trained["tunes"])):]
    legs = []
    for n in sizes.samples:
        validation = ds.write_validation(data_root, val, n)
        cold, warm = (run_cli(out_dir, data_root, validation, n, sizes.new,
                              seed, device, window)
                      for seed in (ds.CLI_SEED, ds.CLI_SEED + 1))
        legs.append(dict(samples=n, window=window or None, cold=cold,
                         warm=warm))
        ds.free(device)
    return legs


def window_quality(trained: dict, model, sizes: ds.Sizes, windows) -> dict:
    """Same-seed generations at each window of ``windows`` (the first the
    reference): agreement of each with the reference, teacher NLL of each
    under ``model``."""
    meta = ds.load_dataset_meta(trained["dataset"])
    prompts = ds.conditioned_prompts(trained["tunes"], meta["stoi"],
                                     sizes.n_gen, sizes.prompt)
    gens = {w: ds.quality_generations(model, prompts, sizes.gen_new, w)
            for w in windows}
    ref = windows[0]
    return dict(
        n_gen=len(prompts), prompt=sizes.prompt, new=sizes.gen_new,
        agreement={str(w): ds.agreement(gens[ref], gens[w], sizes.prompt)
                   for w in windows[1:]},
        teacher_nll={str(w): ds.teacher_nll(model, gens[w], sizes.prompt)
                     for w in windows})


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False, window: int = 128) -> dict:
    trained = ds.measure_random_checkpoint(work_dir, sizes, device, reuse,
                                           n_kv_head=2)
    del trained["model"]  # the studies read the flagship's ckpt.pt
    ds.free(device)
    out_dir = os.path.join(work_dir, "ckpt_kh2")
    legs = cli_legs(trained, out_dir, sizes, device)
    flagship = ds.load_flagship(work_dir, device)

    from ai_music_generation_tpu_torch.decode.generate import Generator

    gen = Generator(flagship, max_new_tokens=sizes.new,
                    temperature=ds.TEMPERATURE, top_k=ds.TOP_K)
    micro = ds.timed_generate(
        gen, ds.random_prompts(flagship.config.vocab_size, sizes.batch, 0),
        sizes.reps, seed=0)
    ds.free(device)
    quality = window_quality(trained, flagship, sizes,
                             (sizes.block_size, window))
    return dict(study="realpath_bench_r5", device=device,
                train=ds.train_summary(trained), cli=legs,
                microbench=micro, window=quality)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    ap.add_argument("--window", type=int, default=128,
                    help="the quality leg's window beside the full one")
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes,
                               args.device, args.reuse, args.window))


if __name__ == "__main__":
    main()
