"""The windowed-refresh contract, quality against context and throughput
against the refresh: the port of ``docs/experiments/refresh_quality.py``.

    python -m ai_music_generation_tpu_torch.experiments.refresh_quality \\
        [--work_dir=studies_out] [--device=cuda] [--reuse] \\
        [--contexts=32,64,128,192,255] [--refreshes=64,128,192]

A char GPT (4L/4H/256d, block 256; bf16, no dropout) trained on the
measure-random corpus (``cli/random_baselines.py::random_tunes(3000, 7)``,
laid out by ``prepare_char``, 2,700 tunes train and 300 val: the script's
recipe, :data:`SCHEDULE`: batch 32, 1,200 iterations, lr 3e-3 to 3e-4,
warmup 40) into ``<work_dir>/ckpt_refresh``, then:

(a) the validation NLL of a window's last token against the context it
    sees: 256 windows of ``block_size + 1`` ids at
    ``np.random.default_rng(0)`` starts, the last ``c`` tokens before the
    target for each ``c`` of ``--contexts``;
(b) ``Generator(refresh=r)`` for each ``r`` of ``--refreshes`` over the
    first 64 windows' first 200 tokens, 500 new tokens, T 0.8, top_k 32:
    a warm-up at seed 0, then three generates at seeds 1-3 timed with CUDA
    events. Every T=1 step runs K1 (MHA, bf16 cache).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ai_music_generation_tpu_torch.experiments import decode_studies as ds

# refresh_quality.py:35-40 (its widths are the Sizes below)
SCHEDULE = dict(
    n_layer=4, n_head=4, n_embd=256, block_size=256, batch_size=32,
    gradient_accumulation_steps=1, max_iters=1200, eval_interval=400,
    eval_iters=20, log_interval=200, warmup_iters=40, lr_decay_iters=1200,
    learning_rate=3e-3, min_lr=3e-4, dtype="bfloat16", dropout=0.0)
# the protocol: 64 prompts of 200 tokens, 500 new tokens, 3 timed generates
SIZES = ds.Sizes(n_layer=4, n_head=4, n_embd=256, iters=1200, n_gen=64,
                 prompt=200, new=500, reps=3)
CONTEXTS = (32, 64, 128, 192, 255)
REFRESHES = (64, 128, 192)
NLL_WINDOWS, WINDOW_SEED = 256, 0  # refresh_quality.py:51-54
TOP_K = 32


def val_windows(dataset: str, block: int, n: int = NLL_WINDOWS) -> np.ndarray:
    """int32 [n, block + 1]: validation windows at ``default_rng(0)``
    starts (refresh_quality.py:49-55)."""
    data = np.memmap(os.path.join(dataset, "val.bin"), dtype=np.uint16,
                     mode="r")
    starts = np.random.default_rng(WINDOW_SEED).integers(
        0, len(data) - (block + 1), size=n)
    return np.stack([data[s:s + block + 1] for s in starts]).astype(np.int32)


@torch.inference_mode()
def last_token_nll(model, x, y_last) -> torch.Tensor:
    """[B] NLL of ``y_last`` after context ``x`` [B, c]: the last
    position's logits, fp32 log-softmax (refresh_quality.py:57-61)."""
    dev = model.transformer.wte.weight.device
    logits, _ = model(torch.as_tensor(np.asarray(x), dtype=torch.long,
                                      device=dev))
    logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    y = torch.as_tensor(np.asarray(y_last), dtype=torch.long, device=dev)
    return -torch.gather(logp, 1, y[:, None])[:, 0]


def nll_vs_context(model, full: np.ndarray, contexts) -> dict:
    """The mean last-token NLL at each context length."""
    block = full.shape[1] - 1
    return {str(c): float(last_token_nll(model, full[:, block - c:block],
                                         full[:, block]).mean())
            for c in contexts}


def throughput(model, prompts: np.ndarray, sizes: ds.Sizes,
               refreshes) -> dict:
    """Each refresh's ms a generate and tokens/s, three timed generates at
    seeds 1-3 after a warm-up at seed 0."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    out = {}
    for r in refreshes:
        gen = Generator(model, max_new_tokens=sizes.new,
                        temperature=ds.TEMPERATURE, top_k=TOP_K, refresh=r)
        out[str(r)] = ds.timed_generate(gen, lambda i: prompts, sizes.reps,
                                        seed=0)
        ds.free(model.transformer.wte.weight.device)
    return out


def run(work_dir: str, sizes: ds.Sizes = SIZES, device: str = "cuda",
        reuse: bool = False, contexts=CONTEXTS,
        refreshes=REFRESHES) -> dict:
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )

    data_root = os.path.join(work_dir, "data")
    dataset = ds.prepare_measure_random(
        data_root, random_tunes(sizes.n_tunes, ds.CORPUS_SEED))
    trained = ds.train_checkpoint(
        os.path.join(work_dir, "ckpt_refresh"), data_root, ds.DATASET,
        ds.schedule_for(sizes, SCHEDULE), device, reuse)
    model = trained.pop("model")
    full = val_windows(dataset, sizes.block_size)
    return dict(
        study="refresh_quality", device=device,
        train=ds.train_summary(trained),
        nll_vs_context=nll_vs_context(model, full, contexts),
        throughput=throughput(model, full[:sizes.n_gen, :sizes.prompt],
                              sizes, refreshes))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap, SIZES)
    ap.add_argument("--contexts", default=",".join(map(str, CONTEXTS)))
    ap.add_argument("--refreshes", default=",".join(map(str, REFRESHES)))
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(
        args.work_dir, sizes, args.device, args.reuse,
        tuple(int(c) for c in args.contexts.split(",")),
        tuple(int(r) for r in args.refreshes.split(","))))


if __name__ == "__main__":
    main()
