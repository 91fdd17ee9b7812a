"""Dataset preparation: text corpora -> train.bin/val.bin/meta.pkl.

Covers the reference's prepare-script family (ref: nanoGPT/data/*/prepare*.py):

- char-level (ref irishman/prepare_char.py): entries stripped + `` $`` suffix,
  space-joined; char vocab; uint16 bins.
- whitespace word-level (ref irishman_whitespace/prepare_whitespace.py):
  same text, whitespace tokens, uint32 bins (vocabs up to ~300k).
- midi-token-text (ref irishman_midi/prepare.py, bach/prepare.py):
  per-piece ``$ `` prefix, space-joined, whitespace tokens, with the vocab
  UNION taken over extra corpora so transfer-learning checkpoints share
  token ids (ref irishman_midi/prepare.py:63-76 union with bach).
- BPE (ref irishman_BPE/prepare_BPE.py): GPT2TokenizerFast retrained at
  vocab 1024, ``<|endoftext|>`` appended per entry.
- WordPiece (ref irishman_wordpiece/prepare_wordpiece.py): BertTokenizerFast
  retrained, ``[SEP]`` appended.

Deviation: the reference builds vocabs from an UNORDERED ``set`` (vocab ids
vary run to run); here vocab lists are sorted, making prepare deterministic.
Counts/sizes still match the golden numbers in the reference comments.

The port's copy of ``ai_music_generation_tpu/data/prepare.py`` (the port
imports nothing of the JAX package): every mode writes the same bins and
meta.pkl as the original's, which tests/test_torch_data_prep.py and
tests/test_torch_host_copies.py hold byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np

from ai_music_generation_tpu_torch.data.memmap import write_bin, write_meta


def _print_length_percentiles(train_lengths, valid_lengths) -> None:
    percentiles = [0, 10, 25, 50, 75, 90, 100]
    for name, lengths in (("Train", train_lengths), ("Validation", valid_lengths)):
        vals = np.percentile(lengths, percentiles) if len(lengths) else []
        print(f"{name} 'abc notation' length percentiles:")
        for p, v in zip(percentiles, vals):
            print(f"  {p}th percentile: {v}")


def entries_to_text(entries: list[dict], key: str = "abc notation") -> str:
    """strip + ' $' suffix per entry, space-joined (ref prepare_char.py:22-27,50)."""
    return " ".join(entry[key].strip() + " $" for entry in entries)


def texts_to_midi_corpus(texts: list[str]) -> str:
    """'$ ' prefix per piece, space-joined (ref irishman_midi/prepare.py:43-49)."""
    return " ".join("$ " + t for t in texts)


def load_texts_from_directory(directory: str) -> list[str]:
    out = []
    for filename in sorted(os.listdir(directory)):
        if filename.lower().endswith(".txt"):
            with open(os.path.join(directory, filename), encoding="utf-8") as f:
                out.append(f.read())
    return out


def _finish(out_dir, train_ids, val_ids, stoi, itos, tokens_format, dtype):
    os.makedirs(out_dir, exist_ok=True)
    print("Vocabulary size:", len(stoi))
    print(f"train has {len(train_ids):,} tokens")
    print(f"val has {len(val_ids):,} tokens")
    write_bin(np.asarray(train_ids, dtype), os.path.join(out_dir, "train.bin"), dtype)
    write_bin(np.asarray(val_ids, dtype), os.path.join(out_dir, "val.bin"), dtype)
    write_meta(
        {
            "vocab_size": len(stoi),
            "itos": itos,
            "stoi": stoi,
            "tokens_format": tokens_format,
            "bin_dtype": np.dtype(dtype).name,
        },
        os.path.join(out_dir, "meta.pkl"),
    )
    return len(stoi), len(train_ids), len(val_ids)


def prepare_char(train_entries, valid_entries, out_dir, key="abc notation"):
    """Char-level corpus (ref: nanoGPT/data/irishman/prepare_char.py)."""
    _print_length_percentiles(
        [len(e[key].strip() + " $") for e in train_entries],
        [len(e[key].strip() + " $") for e in valid_entries],
    )
    train_text = entries_to_text(train_entries, key)
    valid_text = entries_to_text(valid_entries, key)
    chars = sorted(set(train_text + valid_text))
    stoi = {c: i for i, c in enumerate(chars)}
    itos = {i: c for i, c in enumerate(chars)}
    return _finish(
        out_dir,
        [stoi[c] for c in train_text],
        [stoi[c] for c in valid_text],
        stoi, itos, "char", np.uint16,
    )


def prepare_whitespace(train_entries, valid_entries, out_dir, key="abc notation"):
    """Whitespace word-level corpus (ref: prepare_whitespace.py; uint32 bins)."""
    train_text = entries_to_text(train_entries, key)
    valid_text = entries_to_text(valid_entries, key)
    words = sorted(set(train_text.split()) | set(valid_text.split()))
    stoi = {w: i for i, w in enumerate(words)}
    itos = {i: w for i, w in enumerate(words)}
    return _finish(
        out_dir,
        [stoi[w] for w in train_text.split()],
        [stoi[w] for w in valid_text.split()],
        stoi, itos, "whitespace", np.uint32,
    )


def prepare_midi_texts(
    train_dir: str,
    valid_dir: str,
    out_dir: str,
    extra_vocab_dirs: Iterable[str] = (),
):
    """midi-token-text corpus with shared-union vocab for transfer learning
    (ref: irishman_midi/prepare.py, bach/prepare.py)."""
    train_texts = load_texts_from_directory(train_dir)
    valid_texts = load_texts_from_directory(valid_dir)
    print(f"Loaded {len(valid_texts)} texts from the validation directory.")
    print(f"Loaded {len(train_texts)} texts from the train directory.")
    train_text = texts_to_midi_corpus(train_texts)
    valid_text = texts_to_midi_corpus(valid_texts)
    vocab = set(train_text.split()) | set(valid_text.split())
    for extra in extra_vocab_dirs:
        for t in load_texts_from_directory(extra):
            vocab |= set(("$ " + t).split())
    words = sorted(vocab)
    stoi = {w: i for i, w in enumerate(words)}
    itos = {i: w for i, w in enumerate(words)}
    dtype = np.uint16 if len(words) < 2**16 else np.uint32
    return _finish(
        out_dir,
        [stoi[w] for w in train_text.split()],
        [stoi[w] for w in valid_text.split()],
        stoi, itos, "whitespace", dtype,
    )


def prepare_bpe(train_entries, valid_entries, out_dir, vocab_size=1024,
                key="abc notation"):
    """Retrained byte-level BPE (ref: irishman_BPE/prepare_BPE.py)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    texts = [e[key].strip() for e in train_entries]
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(texts, trainer)
    eot = tok.token_to_id("<|endoftext|>")

    def enc(entries):
        ids = []
        for e in entries:
            ids.extend(tok.encode(e[key].strip()).ids)
            ids.append(eot)  # appended per entry (ref :55-62)
        return ids

    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(tok.get_vocab(), f)
    vocab = tok.get_vocab()
    itos = {i: t for t, i in vocab.items()}
    return _finish(out_dir, enc(train_entries), enc(valid_entries),
                   vocab, itos, "bpe", np.uint16)


def prepare_gpt2bpe(text: str, out_dir: str, val_ratio: float = 0.1,
                    assets_dir: Optional[str] = None):
    """GPT-2 BPE corpus from one raw text (the shakespeare recipe, ref:
    nanoGPT/data/shakespeare/prepare.py:13-30): 90/10 character split,
    tiktoken-gpt2 encoding, uint16 bins, NO meta.pkl — the trainer then
    falls back to vocab 50304 (ref: nanoGPT/train.py:165-168; our
    train/trainer.py) and the sampler to tiktoken decode, which is what
    makes configs/finetune_shakespeare.py runnable from input.txt alone.

    Asset resolution (tiktoken → HF cache → encoder.json/vocab.bpe dir) and
    the air-gapped SKIP contract live in data/gpt2_bpe.py."""
    from ai_music_generation_tpu_torch.data.gpt2_bpe import load_gpt2_codec

    codec = load_gpt2_codec(assets_dir)
    split = int(len(text) * (1 - val_ratio))
    train_ids = codec.encode_ordinary(text[:split])
    val_ids = codec.encode_ordinary(text[split:])
    os.makedirs(out_dir, exist_ok=True)
    print(f"train has {len(train_ids):,} tokens")
    print(f"val has {len(val_ids):,} tokens")
    write_bin(np.asarray(train_ids, np.uint16),
              os.path.join(out_dir, "train.bin"), np.uint16)
    write_bin(np.asarray(val_ids, np.uint16),
              os.path.join(out_dir, "val.bin"), np.uint16)
    return codec.n_vocab, len(train_ids), len(val_ids)


def prepare_openwebtext(out_dir: str, num_proc: int = 8,
                        assets_dir: Optional[str] = None):
    """OpenWebText GPT-2 corpus (ref: nanoGPT/data/openwebtext/prepare.py:
    1-81): HF ``openwebtext`` dataset, 0.05% val split at seed 2357,
    per-document ``<|endoftext|>`` (id 50256) terminator, sharded tofile
    writes. Requires network + the HF dataset — in an air-gapped
    environment the load_dataset call below raises and the caller reports
    the documented SKIP (the corpus is 54 GB; there is no offline path)."""
    import datasets as hfd

    from ai_music_generation_tpu_torch.data.gpt2_bpe import load_gpt2_codec

    codec = load_gpt2_codec(assets_dir)
    ds = hfd.load_dataset("openwebtext", num_proc=num_proc)
    split = ds["train"].train_test_split(
        test_size=0.0005, seed=2357, shuffle=True)
    split["val"] = split.pop("test")
    eot = 50256  # <|endoftext|> (ref openwebtext/prepare.py:34)

    def tokenize(example):
        ids = codec.encode_ordinary(example["text"])
        ids.append(eot)
        return {"ids": ids, "len": len(ids)}

    tokenized = split.map(tokenize, remove_columns=["text"],
                          desc="tokenizing", num_proc=num_proc)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, dset in tokenized.items():
        total = int(np.sum(dset["len"], dtype=np.uint64))
        path = os.path.join(out_dir, f"{name}.bin")
        arr = np.memmap(path, dtype=np.uint16, mode="w+", shape=(total,))
        idx = 0
        n_shards = 1024
        for shard_i in range(n_shards):
            shard = dset.shard(num_shards=n_shards, index=shard_i,
                               contiguous=True).with_format("numpy")
            batch = np.concatenate(shard["ids"])
            arr[idx:idx + len(batch)] = batch
            idx += len(batch)
        arr.flush()
        print(f"{name} has {total:,} tokens")
        out[name] = total
    return out


def prepare_wordpiece(train_entries, valid_entries, out_dir, vocab_size=1024,
                      key="abc notation"):
    """Retrained WordPiece (ref: irishman_wordpiece/prepare_wordpiece.py)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    texts = [e[key].strip() for e in train_entries]
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size,
        special_tokens=["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"],
    )
    tok.train_from_iterator(texts, trainer)
    sep = tok.token_to_id("[SEP]")

    def enc(entries):
        ids = []
        for e in entries:
            ids.extend(tok.encode(e[key].strip()).ids)
            ids.append(sep)  # appended per entry (ref :9-41)
        return ids

    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    vocab = tok.get_vocab()
    itos = {i: t for t, i in vocab.items()}
    return _finish(out_dir, enc(train_entries), enc(valid_entries),
                   vocab, itos, "wordpiece", np.uint16)
