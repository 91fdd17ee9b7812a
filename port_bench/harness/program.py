"""The system under test, built from a configuration file: the port's
``models/gpt.py::GPT`` with the benchmark's weights loaded into it. The
only module of the benchmark, with the drivers, that imports the port."""

from __future__ import annotations

import torch

from port_bench.harness import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_gpt(model: dict, seed: int, device, **options):
    """(the port's GPT in eval mode with the seed's weights, those weights
    as made: {name: float32 tensor}). ``options`` are further
    ``GPTConfig`` fields (the cache format, dropout)."""
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    config = GPTConfig(
        block_size=model["block_size"], vocab_size=model["vocab_size"],
        n_layer=model["n_layer"], n_head=model["n_head"],
        n_embd=model["n_embd"], bias=model["bias"],
        n_kv_head=model.get("n_kv_head"), dtype=DTYPES[model["dtype"]],
        param_dtype=DTYPES[model["param_dtype"]], **options)
    gpt = GPT(config, device=device)
    _, views = weights.make(model, seed, device)
    params = dict(gpt.named_parameters())
    if set(params) != set(views):
        raise RuntimeError(f"the port's parameters {sorted(set(params) ^ set(views))} "
                           f"differ from the configuration's leaves")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(views[name])
    return gpt.eval(), views


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
