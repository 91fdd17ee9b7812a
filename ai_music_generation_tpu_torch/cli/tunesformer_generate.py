"""TunesFormer generation CLI of the port, flag-compatible with
``ai_music_generation_tpu/cli/tunesformer_generate.py`` (and, through it,
with the reference's tunesformer/generate.py):

    python -m ai_music_generation_tpu_torch.cli.tunesformer_generate \\
        -num_tunes 16 -max_patch 32 -torch_weights weights.pth

- the same flags and defaults (``-num_tunes -max_patch -top_p -top_k
  -temperature -seed -show_control_code``); the prompt (control codes
  S:/B:/E: and an ABC header) from ``-prompt`` (prompt.txt); control-code
  lines hidden unless ``-show_control_code``;
- each tune gets an ``X:<i>`` header; the tunes, joined by blank lines, go
  to ``<output_dir>/<timestamp>.abc``;
- weights: ``-torch_weights weights.pth`` (a reference checkpoint, the
  reference config), else ``<weights>/weights.pth`` (its architecture read
  from the shapes); an orbax directory (the JAX package's format) raises
  with the conversion command;
- every tune decodes in ONE batch through ``decode/tunes_generate.py`` on
  the card (``-device cpu`` runs on the CPU: the tests do).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ai_music_generation_tpu_torch.utils.device import resolve_device


def get_args(parser: argparse.ArgumentParser, argv=None):
    parser.add_argument("-num_tunes", type=int, default=1,
                        help="the number of independently computed returned tunes")
    parser.add_argument("-max_patch", type=int, default=128,
                        help="integer to define the maximum length in tokens of each tune")
    parser.add_argument("-top_p", type=float, default=0.8,
                        help="float to define the tokens that are within the sample operation of text generation")
    parser.add_argument("-top_k", type=int, default=8,
                        help="integer to define the tokens that are within the sample operation of text generation")
    parser.add_argument("-temperature", type=float, default=1.2,
                        help="the temperature of the sampling operation")
    parser.add_argument("-seed", type=int, default=None, help="seed for randomstate")

    def str2bool(v: str) -> bool:
        # '-show_control_code False' must parse as False (the reference's
        # type=bool made every value True)
        return v.strip().lower() not in ("false", "0", "no", "")

    parser.add_argument("-show_control_code", type=str2bool, default=True,
                        help="whether to show control code")
    parser.add_argument("-weights", type=str, default="tf_out",
                        help="directory holding a weights.pth")
    parser.add_argument("-torch_weights", type=str, default="",
                        help="path to a reference weights.pth")
    parser.add_argument("-prompt", type=str, default="prompt.txt",
                        help="path to the prompt file")
    parser.add_argument("-output_dir", type=str, default="output_tunes")
    parser.add_argument("-device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    return parser.parse_args(argv)


def load_model(weights: str, torch_weights: str = "", device="cuda"):
    """The model (eval mode, bf16 compute) from a reference weights.pth:
    ``torch_weights`` with the reference config, else ``<weights>/
    weights.pth`` with the architecture its shapes give."""
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig, load_tunesformer,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_import import (
        load_reference_checkpoint,
    )

    device = resolve_device(device)
    if torch_weights:
        cfg = TunesFormerConfig(dropout=0.0, dtype=torch.bfloat16)
        model = TunesFormer(cfg, device=device)
        model.load_state_dict(load_reference_checkpoint(torch_weights, cfg))
        return model.eval()
    return load_tunesformer(weights, device=device)[0]


def generate_abc(args) -> str:
    from ai_music_generation_tpu_torch.decode.tunes_generate import (
        TunesGenerator,
    )

    model = load_model(args.weights, getattr(args, "torch_weights", ""),
                       getattr(args, "device", "cuda"))
    with open(args.prompt) as f:
        prompt = f.read()

    print(" HYPERPARAMETERS ".center(60, "#"), "\n")
    for key, val in vars(args).items():
        print(f"{key}: {val}")
    print("\n" + " OUTPUT TUNES ".center(60, "#"))

    start_time = time.time()
    gen = TunesGenerator(model, top_p=args.top_p, top_k=args.top_k,
                         temperature=args.temperature)
    bodies = gen.generate_tunes(
        prompt, num_tunes=args.num_tunes, max_patch=args.max_patch,
        seed=args.seed, show_control_code=args.show_control_code)
    tunes = ""
    for i, body in enumerate(bodies):
        tune = f"X:{i + 1}\n" + body
        print(tune + "\n")
        tunes += tune + "\n\n"
    print("Generation time: {:.2f} seconds".format(time.time() - start_time))

    os.makedirs(args.output_dir, exist_ok=True)
    timestamp = time.strftime("%a_%d_%b_%Y_%H_%M_%S", time.localtime())
    out_path = os.path.join(args.output_dir, timestamp + ".abc")
    with open(out_path, "w") as f:
        f.write(tunes)
    return out_path


if __name__ == "__main__":
    generate_abc(get_args(argparse.ArgumentParser()))
