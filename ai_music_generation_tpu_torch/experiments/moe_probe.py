"""MoE GPT on the card against the dense baseline: the port of
``docs/experiments/moe_tpu.py``.

    python -m ai_music_generation_tpu_torch.experiments.moe_probe \\
        --root=moe_probe_out [--device=cuda]

Protocol (the JAX experiment's, docs/experiments/moe_tpu.py:97-124): a
synthetic corpus of 2,000 phrase-repeating ABC tunes (seed 11), char
tokens padded to a vocabulary of 128; GPT 6 layers, 6 heads, 384 wide,
block 256, batch 64, bf16, dropout 0, lr 1e-3 (warmup 30, cosine to 1e-4
over ``ITERS``); a dense and an MoE trainer (``MOE``: 4 experts, top 2,
capacity factor 1.25, aux weight 0.01) on the same corpus and seed. Then:

- the train step's ms of each, ``STEPS`` steps after the run timed with
  CUDA events (the host clock on the CPU), and their ratio beside the
  ratio of :func:`step_flops` (the experts counted at the capacity rows
  they compute); peak memory;
- MoE decode through ``Generator`` at B=256, 8-token prompts from
  val.bin (a seeded numpy draw), 200 new tokens, T 0.8, top_k 200: tok/s
  (CUDA events, after a warm-up) and two same-seed runs bit-equal.

Prints one line of JSON: {"dense": {...}, "moe": {...}, "ms_ratio",
"flop_ratio", "decode": {...}, "device": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch

from ai_music_generation_tpu_torch.cli.random_baselines import (
    KEY_SIGNATURES,
    TIME_SIGNATURES,
    random_note_seq,
)
from ai_music_generation_tpu_torch.data.memmap import write_bin, write_meta
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.models.gpt import GPTConfig
from ai_music_generation_tpu_torch.models.moe import capacity_of
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS, Trainer

CORPUS = "moe_ds"
VOCAB = 128
PROTOCOL = dict(n_layer=6, n_head=6, n_embd=384, block_size=256,
                batch_size=64, gradient_accumulation_steps=1, bias=False,
                learning_rate=1e-3, warmup_iters=30, min_lr=1e-4,
                dtype="bfloat16", dropout=0.0)
MOE = dict(n_expert=4, expert_top_k=2, capacity_factor=1.25,
           moe_aux_coef=0.01)
DECODE_B, DECODE_PROMPT, DECODE_NEW = 256, 8, 200
ITERS = 300
STEPS = 20


def write_corpus(data_root: str, seed: int = 11) -> str:
    """The JAX experiment's corpus under ``<data_root>/moe_ds``: 2,000
    tunes of 2-5 phrases of 3-6 random notes, each tune a repeated phrase
    sequence; char tokens in sorted order, the vocabulary padded to 128
    with characters that never occur; 90/10 train/val. Returns the
    dataset's directory. The first padding character is ``$``, the sampling
    CLI's prompt marker (``cli/sample.py`` splits its outputs there), so
    that CLI can prompt a model of this corpus with ``--start=$X:``; the
    JAX experiment pads with box-drawing characters only."""
    rng = random.Random(seed)
    tunes = []
    for i in range(2000):
        uniq = [" ".join(random_note_seq(rng, rng.randint(3, 6)))
                for _ in range(rng.randint(2, 5))]
        phrase = [rng.choice(uniq) for _ in range(rng.randint(2, 4))]
        measures = phrase * rng.randint(2, 6)
        tunes.append(
            f"X:{i}\nL:1/8\nM:{rng.choice(TIME_SIGNATURES)}\n"
            f"K:{rng.choice(KEY_SIGNATURES)}\n" + " | ".join(measures) + " |")
    text = "\n\n".join(tunes)
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    itos = dict(enumerate(chars))
    while len(itos) < VOCAB:
        ch = "$" if "$" not in stoi else chr(0x2500 + len(itos))
        stoi[ch], itos[len(itos)] = len(itos), ch
    d = os.path.join(data_root, CORPUS)
    os.makedirs(d, exist_ok=True)
    ids = np.asarray([stoi[c] for c in text], np.uint16)
    split = int(0.9 * len(ids))
    write_bin(ids[:split], os.path.join(d, "train.bin"))
    write_bin(ids[split:], os.path.join(d, "val.bin"))
    write_meta({"vocab_size": len(itos), "itos": itos, "stoi": stoi,
                "tokens_format": "char", "bin_dtype": "uint16"},
               os.path.join(d, "meta.pkl"))
    return d


def trainer_config(data_root: str, out_dir: str, iters: int, moe: bool,
                   device: str = "cuda", **overrides) -> dict:
    """The protocol's trainer config (evals at the start and the end)."""
    c = dict(DEFAULTS, dataset=CORPUS, data_root=data_root, out_dir=out_dir,
             max_iters=iters, eval_interval=iters, eval_iters=20,
             log_interval=100, lr_decay_iters=iters, device=device,
             **PROTOCOL)
    if moe:
        c.update(MOE)
    c.update(overrides)
    return c


def step_flops(cfg: GPTConfig, batch: int) -> int:
    """A train step's matmul FLOPs by formula: 3 x the forward's. Per token
    and layer the forward does 2 x 4C^2 in the attention's projections,
    4 x T x C in its scores and P V (the full T x T, as the einsum chain
    computes), and the MLP's 2 x 8C^2; an MoE layer's experts do that MLP
    over their E x capacity buffer rows (padding included) instead of the
    tokens, plus the router's 2 x C x E; the head 2 x C x V."""
    C, T, L = cfg.n_embd, cfg.block_size, cfg.n_layer
    N = batch * T
    mlp = 16 * C * C * N
    if cfg.n_expert > 0:
        K = min(cfg.expert_top_k, cfg.n_expert)
        rows = cfg.n_expert * capacity_of(N, cfg.n_expert, K,
                                          cfg.capacity_factor)
        mlp = 16 * C * C * rows + 2 * C * cfg.n_expert * N
    forward = L * (8 * C * C * N + 4 * T * C * N + mlp) + 2 * C * \
        cfg.vocab_size * N
    return 3 * forward


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(trainer: Trainer, n: int = STEPS) -> dict:
    """``n`` train steps after the trainer's run (iterations past its
    last): ms a step (CUDA events; the host clock on the CPU), the last
    loss and the peak memory of the steps (GiB; None on the CPU)."""
    device = trainer.device
    batches = [trainer.get_batch("train", trainer.iter_num + i)
               for i in range(n + 1)]
    trainer._train_step(*batches[0], trainer.iter_num, trainer.c["seed"])
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(batches[1:]):
        metrics = trainer._train_step(x, y, trainer.iter_num + 1 + i,
                                      trainer.c["seed"])
    if cuda:
        end.record()
    _sync(device)
    ms = (start.elapsed_time(end) if cuda
          else (time.perf_counter() - t0) * 1e3) / n
    return dict(ms=ms, loss=float(metrics["loss"]),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                          if cuda else None))


def val_prompts(data_root: str, batch: int, length: int,
                seed: int = 0) -> np.ndarray:
    """``batch`` prompts of ``length`` tokens from random starts in
    val.bin (a seeded numpy draw)."""
    val = np.memmap(os.path.join(data_root, CORPUS, "val.bin"),
                    dtype=np.uint16, mode="r")
    starts = np.random.default_rng(seed).integers(0, len(val) - length - 1,
                                                  size=batch)
    return np.stack([val[s:s + length] for s in starts]).astype(np.int32)


@torch.inference_mode()
def decode(model, prompts: np.ndarray, new: int, runs: int = 2,
           seed: int = 1234) -> dict:
    """``Generator`` (T 0.8, top_k 200) over ``prompts``: two same-seed
    generates bit-equal and in range, then tok/s over ``runs`` timed
    generates (CUDA events; the host clock on the CPU)."""
    device = model.transformer.wte.weight.device
    gen = Generator(model, max_new_tokens=new, temperature=0.8, top_k=200)
    a, b = (gen.generate(prompts, seed=seed).cpu() for _ in range(2))
    if not torch.equal(a, b):
        raise AssertionError("MoE decode is not deterministic at a seed")
    if not ((a >= 0) & (a < model.config.vocab_size)).all():
        raise AssertionError("MoE decode token out of range")
    cuda = device.type == "cuda"
    seconds = []
    for i in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        gen.generate(prompts, seed=seed + 1 + i)
        if cuda:
            end.record()
        _sync(device)
        seconds.append(start.elapsed_time(end) / 1e3 if cuda
                       else time.perf_counter() - t0)
    return dict(tok_s=prompts.shape[0] * new / (sum(seconds) / runs),
                seconds=seconds, shape=list(a.shape))


def run(root: str, iters: int = ITERS, device: str = "cuda",
        steps: int = STEPS) -> dict:
    """The whole protocol under ``root`` (corpus, both runs' out_dirs)."""
    data_root = os.path.join(root, "data")
    write_corpus(data_root)
    res = {}
    for name, moe in (("dense", False), ("moe", True)):
        t = Trainer(trainer_config(data_root, os.path.join(root, name),
                                   iters, moe, device))
        t.run()
        with open(os.path.join(t.c["out_dir"], "losses.jsonl")) as f:
            val = [json.loads(line)["val/loss"] for line in f]
        res[name] = dict(time_steps(t, steps), val=val,
                         step_tflop=step_flops(t.gpt_config,
                                               t.micro_batch) / 1e12)
        if moe:
            res["decode"] = decode(t.model, val_prompts(
                data_root, DECODE_B, DECODE_PROMPT), DECODE_NEW)
        del t
        if device == "cuda":
            torch.cuda.empty_cache()
    res["ms_ratio"] = res["moe"]["ms"] / res["dense"]["ms"]
    res["flop_ratio"] = res["moe"]["step_tflop"] / res["dense"]["step_tflop"]
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default="moe_probe_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    res = run(args.root, device=args.device)
    res["device"] = (torch.cuda.get_device_name(0) if args.device == "cuda"
                     else "cpu")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
