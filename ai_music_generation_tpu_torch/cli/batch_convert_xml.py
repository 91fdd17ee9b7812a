"""Batch MusicXML -> ABC conversion.

Parity with ref: tunesformer/data_curation.zip::batch_converter.py — a
multiprocessing pool over .xml/.musicxml/.mxl files producing .abc files
(via the in-repo converter instead of the vendored xml2abc.py).

The port's copy of ``ai_music_generation_tpu/cli/batch_convert_xml.py`` over
the port's ``abcnotation/from_musicxml.py``; it imports no torch, so a
pool worker forked from a process that holds a CUDA context never touches
the card.

    python -m ai_music_generation_tpu_torch.cli.batch_convert_xml xml/ abc/ --processes=2
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
from pathlib import Path

from ai_music_generation_tpu_torch.abcnotation.from_musicxml import musicxml_to_abc


def _convert_one(args: tuple[str, str, int]) -> tuple[str, bool, str]:
    path, out_dir, ref = args
    try:
        abc = musicxml_to_abc(path, reference=ref)
        out = os.path.join(out_dir, Path(path).stem + ".abc")
        with open(out, "w") as f:
            f.write(abc)
        return path, True, ""
    except Exception as e:
        return path, False, str(e)


def convert_directory(input_dir: str, output_dir: str,
                      processes: int | None = None) -> tuple[int, int]:
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(
        str(p) for p in Path(input_dir).iterdir()
        if p.suffix.lower() in (".xml", ".musicxml", ".mxl")
    )
    jobs = [(f, output_dir, i + 1) for i, f in enumerate(files)]
    ok = bad = 0

    def consume(results):
        nonlocal ok, bad
        for path, success, err in results:
            ok += success
            bad += not success
            if err:
                print(f"FAILED {path}: {err}")

    if processes == 1 or len(jobs) <= 1:
        consume(map(_convert_one, jobs))
    else:
        with mp.Pool(processes) as pool:  # close+join workers on exit
            consume(pool.imap_unordered(_convert_one, jobs))
    print(f"converted {ok} files, {bad} failures -> {output_dir}")
    return ok, bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--processes", type=int, default=None)
    a = ap.parse_args(argv)
    return convert_directory(a.input_dir, a.output_dir, a.processes)


if __name__ == "__main__":
    main()
