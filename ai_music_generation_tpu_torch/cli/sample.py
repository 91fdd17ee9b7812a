"""Sampling CLI of the port, flag-compatible with
``ai_music_generation_tpu/cli/sample.py`` (and, through it, with the
reference's nanoGPT sampler):

    python -m ai_music_generation_tpu_torch.cli.sample --out_dir=out \\
        --dataset=irishman --tokens_format=char \\
        --validation_path=data/validation.json --num_samples=1000 \\
        --batch_size=1000 --kv_quantized=True --flat_kv=True

- the same flags (``--key=value``, or a Python config file), the same three
  prompt modes (a fixed ``start`` prompt x num_samples; midi-text: ``start``
  + the first n bars of each validation ``.txt``; irishman char: the
  validation JSON split on the bar regex, 2n pieces), the same
  ``$``-normalization and file names (``samples/sample_<id>.abc`` with an
  ``X:<id>`` header for irishman char, ``samples/sample_<id>.txt`` with the
  trailing-bar fix otherwise);
- prompts decode in batches of ``batch_size`` through the port's
  ``Generator`` (``SpecGenerator`` with ``--speculative``); batch ``lo``
  decodes with seed ``seed + lo``, so the same ``--seed`` and
  ``--batch_size`` (and ``--speculative``) give byte-identical files. The
  port's sampling streams are its own (torch, not JAX threefry): greedy
  fp32 output equals the JAX CLI's, sampled output does not;
- the model loads from ``<out_dir>/ckpt.pt`` (nanoGPT format,
  ``models/nanogpt_ckpt.py``; a GQA or MoE architecture from its
  ``model_args``) onto the CUDA card. ``--device=cpu`` runs on
  the CPU (the tests do); without a card and without that override the run
  raises. An out_dir with only the JAX package's orbax checkpoint raises
  with the conversion command;
- ``--init_from=gpt2*`` samples a HF GPT-2 instead (``models/hf_import.py``:
  a local directory such as ``gpt2-small/`` with ``config.json`` and
  ``model.safetensors`` or ``pytorch_model.bin``, else a HF hub name from
  the local cache), encoding and decoding with tiktoken's ``gpt2``
  encoding, as the JAX CLI does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
from typing import Iterable

import numpy as np
import torch

from ai_music_generation_tpu_torch.data.memmap import load_meta
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides
from ai_music_generation_tpu_torch.utils.device import resolve_device

DEFAULTS = dict(
    use_validation_prefixes=True,
    dataset="bach",
    tokens_format="midi",  # 'char' | 'midi' (midi => whitespace tokens)
    validation_path="",
    n_conditional_measures=4,
    out_dir="out",
    init_from="resume",
    start="$",
    num_samples=1000,
    max_new_tokens=500,
    temperature=0.8,
    top_k=200,
    top_p=1.0,  # nucleus sampling; 1.0 = off
    seed=1337,
    data_root="data",
    batch_size=64,  # batched decode width
    dtype="bfloat16",
    kv_quantized=False,  # int8 KV cache
    flat_kv=False,  # the JAX flat-cache layout flag (the port's cache is
    # always flat; every T=1 step runs ops/gqa_decode.py either way)
    speculative=False,  # prompt-lookup speculative decoding
    n_draft=4,  # draft chain length when speculative=True
    window=0,  # decode KV-cache window; 0 = block_size
    device="cuda",  # "cpu" runs the plain twins on the CPU
)

IRISHMAN_BAR_REGEX = re.compile(r"(:\||::|\s\||\|\])")


def load_model(out_dir: str, dtype: str = "bfloat16",
               init_from: str = "resume", kv_quantized: bool = False,
               flat_kv: bool = False, device: str = "cuda"):
    """(GPT on ``device``, checkpoint meta) from ``<out_dir>/ckpt.pt``, or
    from a HF GPT-2 when ``init_from`` starts with "gpt2" (ref
    sample.py:55-71). ``dtype`` other than "bfloat16" computes in fp32, as
    the JAX CLI."""
    from ai_music_generation_tpu_torch.models.nanogpt_ckpt import load_ckpt

    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if init_from.startswith("gpt2"):
        from ai_music_generation_tpu_torch.models.gpt import GPT
        from ai_music_generation_tpu_torch.models.hf_import import (
            from_pretrained,
        )

        config, state = from_pretrained(init_from)
        config = dataclasses.replace(config, dtype=tdtype, flat_kv=flat_kv)
        model = GPT(config, device=resolve_device(device))
        model.load_state_dict(state)
        return model.eval(), {"model_args": {}, "config": {}}
    torch_ckpt = os.path.join(out_dir, "ckpt.pt")
    if not os.path.exists(torch_ckpt):
        if os.path.exists(os.path.join(out_dir, "ckpt", "meta.json")):
            raise FileNotFoundError(
                f"{out_dir} holds only an orbax checkpoint (ckpt/), which "
                "needs jax; convert it first with `python -m "
                "ai_music_generation_tpu.cli.convert_ckpt gpt to-torch "
                f"--out_dir {out_dir} --out {torch_ckpt}`")
        raise FileNotFoundError(f"no checkpoint at {torch_ckpt}")
    return load_ckpt(torch_ckpt, device=resolve_device(device), dtype=tdtype,
                     kv_quantized=kv_quantized, flat_kv=flat_kv)


def build_codec(meta_ckpt: dict, data_root: str, tokens_format: str):
    """encode/decode closures from the dataset meta.pkl."""
    dataset = meta_ckpt.get("config", {}).get("dataset")
    meta = load_meta(os.path.join(data_root, dataset, "meta.pkl")) if dataset else None
    if meta is None:
        raise FileNotFoundError(
            f"meta.pkl not found for dataset {dataset!r} under {data_root!r}"
        )
    stoi, itos = meta["stoi"], meta["itos"]
    # vectorized decode: a numpy lookup table and one join
    lut = np.array([itos[i] for i in range(len(itos))], dtype=object)
    joiner = "" if tokens_format == "char" else " "
    decode = lambda l: joiner.join(lut[np.asarray(l, np.int64)].tolist())  # noqa: E731,E741
    if tokens_format == "char":
        encode = lambda s: [stoi[c] for c in s]  # noqa: E731
    else:
        encode = lambda s: [stoi[c] for c in s.split()]  # noqa: E731
    return encode, decode


def prompt_iter(c: dict) -> Iterable[tuple[object, str]]:
    """(id, prompt) pairs of the three prompt modes."""
    start = c["start"]
    if start.startswith("FILE:"):
        with open(start[5:], encoding="utf-8") as f:
            start = f.read()

    if not c["use_validation_prefixes"]:
        return ((i, start) for i in range(c["num_samples"]))

    if not c["validation_path"]:
        raise ValueError("use_validation_prefixes is True but validation_path not set")

    if c["tokens_format"] == "midi":
        pairs = []
        for fname in sorted(os.listdir(c["validation_path"])):
            if fname.endswith(".txt"):
                with open(os.path.join(c["validation_path"], fname)) as f:
                    text = f.read()
                prefix = (
                    start + " "
                    + "|".join(text.split("|")[: c["n_conditional_measures"]]).strip()
                    + " |"
                )
                pairs.append((fname[:-4], prefix))
        return iter(pairs)

    if c["dataset"] == "irishman" and c["tokens_format"] == "char":
        with open(c["validation_path"]) as f:
            leadsheets = json.load(f)
        pairs = []
        for sheet in leadsheets:
            pieces = IRISHMAN_BAR_REGEX.split(sheet.get("abc notation"))
            pairs.append(
                (sheet.get("id"),
                 start + "".join(pieces[: c["n_conditional_measures"] * 2]))
            )
        return iter(pairs)

    raise NotImplementedError(
        f"prompt mode dataset={c['dataset']} tokens_format={c['tokens_format']}"
    )


def normalize_output(res: str, sample_id, dataset: str, tokens_format: str) -> tuple[str, str]:
    """(filename, normalized text) of one sample."""
    if tokens_format == "char" and dataset == "irishman":
        return f"sample_{sample_id}.abc", f"X:{sample_id}\n" + res.split("$")[1].strip()
    normalized = res.split("$")[1].strip()
    if not normalized.endswith("|"):
        # the reference's quirk, kept byte for byte: the fallback rebuilds
        # from the unstripped `res`, reintroducing the '$ ' prompt marker
        normalized = "|".join(res.split("|")[:-1]).strip() + " |"
    return f"sample_{sample_id}.txt", normalized


def run_sampling(c: dict, write: bool = True) -> list[tuple[object, str]]:
    """Batched generation over all prompts; returns [(id, normalized_text)]."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    model, ckpt_meta = load_model(
        c["out_dir"], c["dtype"], c["init_from"],
        c.get("kv_quantized", False), c.get("flat_kv", False),
        c.get("device", "cuda"))
    if c["init_from"].startswith("gpt2"):
        # GPT-2 BPE fallback (ref: sample.py:96-100)
        import tiktoken

        enc = tiktoken.get_encoding("gpt2")
        encode = lambda s: enc.encode(s, allowed_special={"<|endoftext|>"})  # noqa: E731
        decode = lambda l: enc.decode(list(map(int, l)))  # noqa: E731,E741
    else:
        encode, decode = build_codec(ckpt_meta, c["data_root"],
                                     c["tokens_format"])
    prompts = list(prompt_iter(c))
    top_p = None if c["top_p"] >= 1.0 else c["top_p"]
    if c.get("speculative"):
        gen = SpecGenerator(model, max_new_tokens=c["max_new_tokens"],
                            temperature=c["temperature"], top_k=c["top_k"],
                            n_draft=c["n_draft"], top_p=top_p)
    else:
        gen = Generator(model, max_new_tokens=c["max_new_tokens"],
                        temperature=c["temperature"], top_k=c["top_k"],
                        top_p=top_p, window=c["window"] or None)

    out_dir = os.path.join(c["out_dir"], "samples")
    if write:
        os.makedirs(out_dir, exist_ok=True)

    results = []
    B = c["batch_size"]
    bs = model.config.block_size
    for lo in range(0, len(prompts), B):
        chunk = prompts[lo: lo + B]
        ids = [encode(p) for _, p in chunk]
        # crop over-long prompts from the left (keep the most recent context)
        ids = [i[-bs + 1:] if len(i) >= bs else i for i in ids]
        maxlen = max(len(i) for i in ids)
        padded = np.zeros((len(ids), maxlen), np.int32)
        lens = np.zeros((len(ids),), np.int32)
        for j, seq in enumerate(ids):
            padded[j, : len(seq)] = seq
            lens[j] = len(seq)
        # one seed per batch: the same seed and batch_size give the same
        # files
        tokens = gen.generate(padded, lens, seed=c["seed"] + lo).cpu().numpy()
        for j, (sample_id, _prompt) in enumerate(chunk):
            res = decode(tokens[j, : lens[j] + c["max_new_tokens"]])
            fname, text = normalize_output(
                res, sample_id, c["dataset"], c["tokens_format"])
            results.append((sample_id, text))
            if write:
                with open(os.path.join(out_dir, fname), "w") as f:
                    f.write(text)
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    results = run_sampling(c)
    print(f"wrote {len(results)} samples to {os.path.join(c['out_dir'], 'samples')}")
    return results


if __name__ == "__main__":
    main()
