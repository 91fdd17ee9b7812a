"""Transfer-learning experiment: melody pretrain -> chorale fine-tune.

Runs the reference's signature cross-dataset experiment end to end
(ref: nanoGPT/config/bach_from_irishman_512_context.py:5 —
``init_from="resume"`` into a checkpoint trained on another corpus whose
prepare step built a UNION vocab, ref: nanoGPT/data/irishman_midi/
prepare.py:63-76) on corpora this repo synthesizes itself:

1. corpus A ("irishman" stand-in): monophonic melodies — soprano lines of
   ``data/chorales.py`` pieces — as quantized midi-text;
2. corpus B ("bach"): full SATB chorales as midi-text;
   both prepared with the union vocab so token ids are shared;
3. train A from scratch (``pretrain_iters``);
4. copy A's checkpoint into a fresh out_dir and fine-tune on B with
   ``init_from=resume`` for ``finetune_iters`` more steps (the reference's
   exact mechanism: max_iters continues past the pretrain count, ref
   bach_from_irishman max_iters 352250 = irishman's 350000 + 2250);
5. train B from scratch for the same number of optimizer steps;
6. print a val-loss table and append it to docs/experiments/.

Every stage is the public CLI surface (bach_pipeline, midi_to_text,
prepare, cli.train), so this doubles as an end-to-end system test.

The port's copy of ``ai_music_generation_tpu/cli/transfer_experiment.py``:
the corpora and the union-vocab data are the original's byte for byte, and
the three legs train through the port's ``cli/train.py`` with the same
flags plus ``--device``. They train on the CUDA card; ``--device=cpu``
trains on the CPU (the tests do), and without a card and without that flag
the experiment raises before it writes anything.

    python -m ai_music_generation_tpu_torch.cli.transfer_experiment \\
        --work_dir=transfer_exp --doc_out=results.md
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from ai_music_generation_tpu_torch.utils.device import resolve_device


def _write_melody_corpus(midi_dir: str, n: int, seed: int) -> None:
    """Monophonic corpus: soprano lines of synthesized chorales."""
    from ai_music_generation_tpu_torch.codec import midi_io
    from ai_music_generation_tpu_torch.codec.score import Score, score_to_midi
    from ai_music_generation_tpu_torch.data.chorales import synthesize_chorale

    os.makedirs(midi_dir, exist_ok=True)
    for i in range(n):
        score = synthesize_chorale(seed * 999_983 + i)
        melody = Score(parts=score.parts[:1])
        midi_io.write_midi_file(
            score_to_midi(melody), os.path.join(midi_dir, f"mel{i:04d}.mid"))


def _midis_to_texts(midi_dir: str, text_dir: str) -> None:
    from ai_music_generation_tpu_torch.cli.midi_to_text import main as m2t

    m2t([midi_dir, text_dir, "--processes=1"])


def _split_dir(src: str, train_dir: str, val_dir: str, every: int = 10):
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    for i, name in enumerate(sorted(os.listdir(src))):
        dst = val_dir if i % every == 0 else train_dir
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def _last_val_loss(out_dir: str) -> float:
    best = float("inf")
    with open(os.path.join(out_dir, "losses.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "val/loss" in row:
                best = min(best, row["val/loss"])
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work_dir", default="transfer_exp")
    ap.add_argument("--n_melodies", type=int, default=400)
    ap.add_argument("--n_chorales", type=int, default=120)
    ap.add_argument("--pretrain_iters", type=int, default=600)
    ap.add_argument("--finetune_iters", type=int, default=300)
    ap.add_argument("--n_layer", type=int, default=4)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=256)
    ap.add_argument("--block_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--eval_interval", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--doc_out", default="")
    ap.add_argument("--device", default="cuda")  # 'cuda' | 'cpu'
    a = ap.parse_args(argv)
    resolve_device(a.device)

    w = a.work_dir
    if os.path.isdir(w):
        # every subdirectory is derived from the flags; a re-run with
        # different --n_melodies/--seed must not mix stale corpus, split,
        # or checkpoint files into the new experiment
        shutil.rmtree(w)
    from ai_music_generation_tpu_torch.cli.bach_pipeline import main as bach_main
    from ai_music_generation_tpu_torch.cli.train import main as train_main
    from ai_music_generation_tpu_torch.data.prepare import prepare_midi_texts

    # -- corpora ----------------------------------------------------------
    print("== corpora ==")
    _write_melody_corpus(f"{w}/midi_melody", a.n_melodies, a.seed)
    bach_main(["synthesize-corpus", f"--out_dir={w}/midi_bach",
               f"--num_pieces={a.n_chorales}", f"--seed={a.seed}",
               "--include_blacklisted=0"])
    _midis_to_texts(f"{w}/midi_melody", f"{w}/text_melody")
    _midis_to_texts(f"{w}/midi_bach", f"{w}/text_bach")
    _split_dir(f"{w}/text_melody", f"{w}/mel_train", f"{w}/mel_val")
    _split_dir(f"{w}/text_bach", f"{w}/bach_train", f"{w}/bach_val")

    # -- prepare with UNION vocab (shared ids across both corpora) --------
    print("== prepare (union vocab) ==")
    prepare_midi_texts(
        f"{w}/mel_train", f"{w}/mel_val", f"{w}/data/melody",
        extra_vocab_dirs=(f"{w}/bach_train", f"{w}/bach_val"))
    prepare_midi_texts(
        f"{w}/bach_train", f"{w}/bach_val", f"{w}/data/bach",
        extra_vocab_dirs=(f"{w}/mel_train", f"{w}/mel_val"))

    common = [
        f"--data_root={w}/data",
        f"--n_layer={a.n_layer}", f"--n_head={a.n_head}",
        f"--n_embd={a.n_embd}", f"--block_size={a.block_size}",
        f"--batch_size={a.batch_size}",
        "--gradient_accumulation_steps=1", "--dropout=0.1",
        "--learning_rate=1e-3", "--min_lr=1e-4", "--beta2=0.99",
        "--warmup_iters=50", f"--eval_interval={a.eval_interval}",
        "--eval_iters=20",
        "--log_interval=50", "--always_save_checkpoint=True",
        "--dtype=bfloat16", f"--device={a.device}",
    ]

    # -- leg 1: pretrain on melodies --------------------------------------
    print("== leg 1: scratch on melody corpus ==")
    train_main(["--dataset=melody", f"--out_dir={w}/out_melody",
                f"--max_iters={a.pretrain_iters}",
                f"--lr_decay_iters={a.pretrain_iters}"] + common)

    # -- leg 2: resume into the chorale corpus (the transfer) --------------
    print("== leg 2: resume melody ckpt on bach corpus ==")
    total = a.pretrain_iters + a.finetune_iters
    if os.path.isdir(f"{w}/out_transfer"):
        shutil.rmtree(f"{w}/out_transfer")
    shutil.copytree(f"{w}/out_melody", f"{w}/out_transfer")
    # the copied losses.jsonl holds MELODY-corpus evals; the transfer leg's
    # val-loss record must contain only bach evals
    os.remove(f"{w}/out_transfer/losses.jsonl")
    train_main(["--dataset=bach", f"--out_dir={w}/out_transfer",
                "--init_from=resume",
                f"--max_iters={total}", f"--lr_decay_iters={total}"] + common)

    # -- leg 3: scratch on the chorale corpus, equal fine-tune steps ------
    print("== leg 3: scratch on bach corpus ==")
    train_main(["--dataset=bach", f"--out_dir={w}/out_scratch",
                f"--max_iters={a.finetune_iters}",
                f"--lr_decay_iters={a.finetune_iters}"] + common)

    transfer = _last_val_loss(f"{w}/out_transfer")
    scratch = _last_val_loss(f"{w}/out_scratch")
    melody = _last_val_loss(f"{w}/out_melody")
    verdict = "beats" if transfer < scratch else "does NOT beat"
    print("\n== results ==")
    print(f"melody pretrain best val loss: {melody:.4f}")
    print(f"bach TRANSFER  best val loss: {transfer:.4f} "
          f"({a.finetune_iters} fine-tune iters)")
    print(f"bach SCRATCH   best val loss: {scratch:.4f} "
          f"({a.finetune_iters} iters)")
    print(f"transfer {verdict} scratch at equal bach steps")
    if a.doc_out:
        with open(a.doc_out, "a") as f:
            f.write(
                f"| {a.n_layer}L/{a.n_head}H/{a.n_embd}d ctx{a.block_size} "
                f"| {a.pretrain_iters} | {a.finetune_iters} "
                f"| {melody:.4f} | {transfer:.4f} | {scratch:.4f} "
                f"| {verdict} |\n")
    return {"melody": melody, "transfer": transfer, "scratch": scratch}


if __name__ == "__main__":
    main()
