"""TunesFormer training-data curation, the port of
``ai_music_generation_tpu/cli/add_control_codes.py``: a directory of ABC
files -> ``data.json`` with S:/B:/E: control codes.

    python -m ai_music_generation_tpu_torch.cli.add_control_codes abc_dir \\
        --output=data.json

Every ``*.abc`` file of ``abc_dir`` (sorted by name) goes through
``data/curation.py::build_control_code_dataset``; the file is the JAX CLI's,
byte for byte (tests/test_torch_host_copies.py).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ai_music_generation_tpu_torch.data.curation import (
    build_control_code_dataset,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("abc_dir")
    ap.add_argument("--output", default="data.json")
    a = ap.parse_args(argv)
    texts = []
    for path in sorted(Path(a.abc_dir).glob("*.abc")):
        texts.append(path.read_text(encoding="utf-8", errors="replace"))
    data = build_control_code_dataset(texts)
    with open(a.output, "w") as f:
        json.dump(data, f, indent=2)
    print(f"curated {len(data)}/{len(texts)} tunes -> {a.output}")
    return len(data)


if __name__ == "__main__":
    main()
