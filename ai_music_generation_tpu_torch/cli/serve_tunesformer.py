"""TunesFormer generation server CLI of the port (continuous-batching bar
decode, ``serve/tunes_engine.py``), flag-compatible with
``ai_music_generation_tpu/cli/serve_tunesformer.py``:

    python -m ai_music_generation_tpu_torch.cli.serve_tunesformer \\
        --weights=tf_out --port=8001 --n_slots=16

then:

    curl -s localhost:8001/generate \\
        -d '{"prompt": "S:2\\nB:9\\nE:4\\nB:9\\nL:1/8\\nM:3/4\\nK:D\\n de", "seed": 3}'

Weights: ``--torch_weights=weights.pth`` (a reference checkpoint, the
reference config), else ``<weights>/weights.pth``. ``--device=cpu`` serves
from the CPU (the plain twins, for tests).
"""

from __future__ import annotations

import sys

from ai_music_generation_tpu_torch.cli.tunesformer_generate import load_model
from ai_music_generation_tpu_torch.serve.http import EngineRunner, serve_tunes
from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides

DEFAULTS = dict(
    weights="tf_out",
    torch_weights="",
    host="127.0.0.1",
    port=8001,
    n_slots=16,
    admit_group=256,
    prewarm=False,  # run one short tune before serving
    device="cuda",
)


def build_server(c: dict):
    """(engine runner, HTTP server) for the config ``c``; the caller runs
    ``serve_forever`` and, at the end, ``runner.shutdown()``."""
    model = load_model(c["weights"], c["torch_weights"], c["device"])
    engine = TunesServer(model, n_slots=c["n_slots"],
                         admit_group=c["admit_group"])
    if c["prewarm"]:
        print("prewarming the bar step...", flush=True)
        engine.prewarm()
    runner = EngineRunner(engine)
    return runner, serve_tunes(runner, c["host"], c["port"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    runner, httpd = build_server(c)
    print(f"serving TunesFormer {c['torch_weights'] or c['weights']} on "
          f"{c['host']}:{httpd.server_address[1]} ({c['n_slots']} slots)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        runner.shutdown()


if __name__ == "__main__":
    main()
