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
experts route all ``n_slots`` rows of a tick together. ``--device=cpu``
serves from the CPU (the plain twins, for tests).

``--mesh=NxM`` serves sharded over a (data=N, model=M) mesh of N*M
processes, one a card, started by ``torchrun`` (the CLI joins the process
group: ``parallel/distributed.py``):

    torchrun --nproc_per_node=4 -m ai_music_generation_tpu_torch.cli.serve \
        --out_dir=out --mesh=2x2 --n_slots=8192 ...

Rank 0 serves HTTP; the other ranks follow its steps
(``serve/engine.py``, ``serve/mesh.py``) and exit when it shuts down.
``--mesh`` without ``torchrun`` raises.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.cli.sample import build_codec, load_model
from ai_music_generation_tpu_torch.parallel.distributed import (
    initialize_distributed,
    shutdown,
)
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
    mesh="",  # "NxM": serve over a (data=N, model=M) mesh under torchrun
    device="cuda",
)


def build_server(c: dict):
    """(engine runner, HTTP server) for the config ``c``; the caller runs
    ``serve_forever`` and, at the end, ``runner.shutdown()``. With
    ``--mesh`` (a process group up) a rank other than 0 gets (the engine,
    None): it calls the engine's ``follow()``."""
    mesh = None
    if c["mesh"]:
        if not dist.is_initialized():
            raise RuntimeError(
                "--mesh serves over a mesh of processes: start under "
                "torchrun (cli/serve.py joins the process group)")
        from ai_music_generation_tpu_torch.parallel.mesh import make_mesh

        n_data, n_model = (int(x) for x in c["mesh"].lower().split("x"))
        mesh = make_mesh(n_data, n_model, torch.device(c["device"]).type)
    model, ckpt_meta = load_model(
        c["out_dir"], c["dtype"], c["init_from"], c["kv_quantized"],
        c["flat_kv"], c["device"])
    encode, decode = build_codec(ckpt_meta, c["data_root"], c["tokens_format"])
    engine = GenerationServer(
        model, n_slots=c["n_slots"], ticks_per_call=c["ticks_per_call"],
        admit_group=c["admit_group"], cache_len=c["cache_len"] or None,
        mesh=mesh)
    if mesh is not None and not engine.link.controller:
        return engine, None
    if c["prewarm"]:
        print("prewarming admission and decode shapes...", flush=True)
        engine.prewarm()
    runner = EngineRunner(engine)
    return runner, serve(runner, encode, decode, c["host"], c["port"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    joined = c["mesh"] and not dist.is_initialized()
    if c["mesh"]:
        initialize_distributed(c["device"])
    try:
        runner, httpd = build_server(c)
        if httpd is None:  # a follower of rank 0's steps
            runner.follow()
            return
        print(f"serving {c['out_dir']} on {c['host']}:"
              f"{httpd.server_address[1]} ({c['n_slots']} slots)")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
            runner.shutdown()
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
