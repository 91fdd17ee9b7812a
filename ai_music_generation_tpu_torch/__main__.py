"""Project CLI: ``python -m ai_music_generation_tpu_torch run [--pipeline NAME]``.

Replaces the Kedro entry point (ref: src/ai_music_generation/__main__.py:40-48).

The port's copy of ``ai_music_generation_tpu/__main__.py``: ``python -m
ai_music_generation_tpu_torch run`` runs the port's pipelines over the
shared ``conf/base/catalog.yaml`` (relative to the working directory, as
the original).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="ai_music_generation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a registered pipeline")
    runp.add_argument("--pipeline", default="__default__")
    runp.add_argument("--catalog", default=os.path.join("conf", "base", "catalog.yaml"))
    a = ap.parse_args(argv)

    if a.cmd == "run":
        from ai_music_generation_tpu_torch.project.framework import (
            DataCatalog,
            register_pipelines,
        )

        pipelines = register_pipelines()
        if a.pipeline not in pipelines:
            raise SystemExit(
                f"unknown pipeline {a.pipeline!r}; available: {sorted(pipelines)}"
            )
        catalog = (
            DataCatalog.from_yaml(a.catalog)
            if os.path.exists(a.catalog)
            else DataCatalog()
        )
        pipelines[a.pipeline].run(catalog)
        print(f"pipeline {a.pipeline!r} completed")


if __name__ == "__main__":
    main()
