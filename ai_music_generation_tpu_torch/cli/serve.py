"""Generation server CLI of the port: continuous-batching decode over a
``ckpt.pt`` on the card, flag-compatible with
``ai_music_generation_tpu/cli/serve.py``:

    python -m ai_music_generation_tpu_torch.cli.serve --out_dir=out \\
        --port=8000 --n_slots=64

then:

    curl -s localhost:8000/generate -d '{"prompt": "$ /0 o0 p60 d12", "max_new_tokens": 200}'

The headline serving configuration of docs/SERVING.md, for a GQA
checkpoint: ``--kv_quantized=True --flat_kv=True --n_slots=8192
--cache_len=128 --ticks_per_call=64 --admit_group=512``. An MoE checkpoint
(``model_args`` with ``n_expert``) serves as it is: every slot ticks, so the
experts route all ``n_slots`` rows of a tick together. ``--mesh`` (sharded
serving) is not ported yet and raises (ROADMAP queue 1 item 6b);
``--device=cpu`` serves from the CPU
(the plain twins, for tests).
"""

from __future__ import annotations

import sys

from ai_music_generation_tpu_torch.cli.sample import build_codec, load_model
from ai_music_generation_tpu_torch.serve.engine import GenerationServer
from ai_music_generation_tpu_torch.serve.http import EngineRunner, serve
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides

DEFAULTS = dict(
    out_dir="out",
    init_from="resume",
    data_root="data",
    tokens_format="midi",
    host="127.0.0.1",
    port=8000,
    n_slots=64,
    ticks_per_call=32,
    admit_group=64,
    cache_len=0,  # ring-cache length; 0 = block_size. Smaller = the
    # decode-window lever: every token still sees >= cache_len/2 context
    dtype="bfloat16",
    kv_quantized=False,
    flat_kv=False,
    prewarm=False,  # run every admission shape once before serving
    mesh="",  # "NxM" sharded serving: not ported yet (item 6b)
    device="cuda",
)


def build_server(c: dict):
    """(engine runner, HTTP server) for the config ``c``; the caller runs
    ``serve_forever`` and, at the end, ``runner.shutdown()``."""
    model, ckpt_meta = load_model(
        c["out_dir"], c["dtype"], c["init_from"], c["kv_quantized"],
        c["flat_kv"], c["device"])
    encode, decode = build_codec(ckpt_meta, c["data_root"], c["tokens_format"])
    engine = GenerationServer(
        model, n_slots=c["n_slots"], ticks_per_call=c["ticks_per_call"],
        admit_group=c["admit_group"], cache_len=c["cache_len"] or None,
        mesh=c["mesh"] or None)
    if c["prewarm"]:
        print("prewarming admission and decode shapes...", flush=True)
        engine.prewarm()
    runner = EngineRunner(engine)
    return runner, serve(runner, encode, decode, c["host"], c["port"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    runner, httpd = build_server(c)
    print(f"serving {c['out_dir']} on {c['host']}:{httpd.server_address[1]} "
          f"({c['n_slots']} slots)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        runner.shutdown()


if __name__ == "__main__":
    main()
