"""Batch TunesFormer sampling over validation leadsheets, the port of
``ai_music_generation_tpu/cli/sample_tunesformer.py``:

    python -m ai_music_generation_tpu_torch.cli.sample_tunesformer \\
        validation.json --weights=tf_out --max_patch=128

For each leadsheet (``id``, ``abc notation``, optional ``control code``)
the prompt is its control code plus its first ``--n_measures`` measures
(split on ``(:\\||::|\\s\\||\\|\\])``); one tune is generated (seed
``--seed``, else the crc32 of the id) and written to
``<output_dir>/sample_<id>.abc`` with an ``X:<id>`` header. Weights:
``<weights>/weights.pth`` (``models/tunesformer.py::load_tunesformer``);
``--device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import zlib
from pathlib import Path

BAR_SPLIT_RE = re.compile(r"(:\||::|\s\||\|\])")


def prefixes_from_leadsheets(leadsheets, n_measures: int):
    """(id, control_code, prefix_abc) per leadsheet."""
    out = []
    for sheet in leadsheets:
        _id = str(sheet.get("id"))
        parts = BAR_SPLIT_RE.split(sheet.get("abc notation", ""))
        prefix = "".join(parts[: n_measures * 2])
        out.append((_id, sheet.get("control code", ""), prefix))
    return out


def normalize_abc(text: str, sample_id: str) -> str:
    """X:<id> header + the generated body (a leading X: line dropped)."""
    body = text.strip()
    lines = body.split("\n")
    if lines and lines[0].startswith("X:"):
        lines = lines[1:]
    return f"X:{sample_id}\n" + "\n".join(lines).strip() + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("validation_json",
                    help="leadsheet JSON with 'id', 'abc notation' (+optional 'control code')")
    ap.add_argument("--weights", default="tf_out")
    ap.add_argument("--output_dir", default="samples")
    ap.add_argument("--n_measures", type=int, default=4)
    ap.add_argument("--max_patch", type=int, default=128)
    ap.add_argument("--top_p", type=float, default=0.8)
    ap.add_argument("--top_k", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--show_control_code", action="store_true")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    from ai_music_generation_tpu_torch.decode.tunes_generate import (
        TunesGenerator,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        load_tunesformer,
    )
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    model, _ = load_tunesformer(a.weights, device=resolve_device(a.device))
    gen = TunesGenerator(model, top_p=a.top_p, top_k=a.top_k,
                         temperature=a.temperature)

    with open(a.validation_json) as f:
        leadsheets = json.load(f)
    prompts = prefixes_from_leadsheets(leadsheets, a.n_measures)
    if a.limit:
        prompts = prompts[: a.limit]

    os.makedirs(a.output_dir, exist_ok=True)
    n = 0
    for _id, control_code, prefix in prompts:
        prompt = (control_code + "\n" if control_code
                  and not control_code.endswith("\n") else control_code) + prefix
        tunes = gen.generate_tunes(
            prompt, num_tunes=1, max_patch=a.max_patch,
            seed=a.seed if a.seed is not None else zlib.crc32(_id.encode()),
            show_control_code=a.show_control_code)
        out_path = Path(a.output_dir) / f"sample_{_id}.abc"
        out_path.write_text(normalize_abc(tunes[0], _id))
        n += 1
    print(f"wrote {n} samples to {a.output_dir}")
    return n


if __name__ == "__main__":
    main()
