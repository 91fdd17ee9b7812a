"""Dataset prepare CLI (the nanoGPT/data/*/prepare*.py family); the port of
``ai_music_generation_tpu/cli/prepare.py``, with its flags, modes (char,
whitespace, bpe, wordpiece, midi, gpt2bpe, openwebtext) and exit behaviour.

    python -m ai_music_generation_tpu_torch.cli.prepare char \\
        --train_json train.json --valid_json validation.json --out_dir data/irishman
    python -m ai_music_generation_tpu_torch.cli.prepare midi \\
        --train_dir .../train/midi_texts --valid_dir .../validation/midi_texts \\
        --out_dir data/bach --extra_vocab_dirs .../irishman/midi_texts
"""

from __future__ import annotations

import argparse
import json

from ai_music_generation_tpu_torch.data import prepare as P


def _load(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["char", "whitespace", "bpe", "wordpiece",
                                     "midi", "gpt2bpe", "openwebtext"])
    ap.add_argument("--train_json")
    ap.add_argument("--valid_json")
    ap.add_argument("--train_dir")
    ap.add_argument("--valid_dir")
    ap.add_argument("--text", help="single raw text file; split val_ratio off the"
                    " end (the shakespeare_char recipe, ref: "
                    "nanoGPT/data/shakespeare_char/prepare.py)")
    ap.add_argument("--val_ratio", type=float, default=0.1)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--extra_vocab_dirs", nargs="*", default=[])
    ap.add_argument("--vocab_size", type=int, default=1024)
    ap.add_argument("--bpe_assets", help="dir with encoder.json + vocab.bpe "
                    "(gpt2bpe/openwebtext modes; falls back to tiktoken / "
                    "HF cache — see data/gpt2_bpe.py)")
    ap.add_argument("--num_proc", type=int, default=8)
    a = ap.parse_args(argv)

    if a.mode == "gpt2bpe":
        # the shakespeare recipe (ref: nanoGPT/data/shakespeare/prepare.py):
        # one raw text file -> uint16 GPT-2 BPE bins, no meta.pkl
        if not a.text:
            ap.error("gpt2bpe mode requires --text input.txt")
        with open(a.text, encoding="utf-8") as f:
            text = f.read()
        return P.prepare_gpt2bpe(text, a.out_dir, a.val_ratio, a.bpe_assets)
    if a.mode == "openwebtext":
        return P.prepare_openwebtext(a.out_dir, a.num_proc, a.bpe_assets)
    if a.mode == "midi":
        return P.prepare_midi_texts(a.train_dir, a.valid_dir, a.out_dir,
                                    a.extra_vocab_dirs)
    if a.text:
        with open(a.text) as f:
            text = f.read()
        split = int(len(text) * (1 - a.val_ratio))
        train = [{"abc notation": text[:split]}]
        valid = [{"abc notation": text[split:]}]
    else:
        train = _load(a.train_json)
        valid = _load(a.valid_json)
    if a.mode == "char":
        return P.prepare_char(train, valid, a.out_dir)
    if a.mode == "whitespace":
        return P.prepare_whitespace(train, valid, a.out_dir)
    if a.mode == "bpe":
        return P.prepare_bpe(train, valid, a.out_dir, a.vocab_size)
    if a.mode == "wordpiece":
        return P.prepare_wordpiece(train, valid, a.out_dir, a.vocab_size)


if __name__ == "__main__":
    main()
