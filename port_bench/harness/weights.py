"""The weights of a GPT configuration, made from the seed on the device in
a few large calls: one float32 buffer, its normal part drawn at once from
a ``torch.Generator`` on that device, then scaled by group (std 0.02; the
residual projections 0.02 / sqrt(2 L), as GPT-2 initialises); LayerNorm
scales 1, biases 0. Leaves are views of the buffer under nanoGPT's names
(the head is tied to ``transformer.wte.weight``)."""

from __future__ import annotations

import math

import torch


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every leaf; init is "normal", "proj" (the
    residual projections), "one" or "zero"."""
    C, H, L = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    KHD = (cfg.get("n_kv_head") or H) * (C // H)
    bias = cfg["bias"]
    out = [("transformer.wte.weight", (cfg["vocab_size"], C), "normal"),
           ("transformer.wpe.weight", (cfg["block_size"], C), "normal")]

    def ln(prefix):
        out.append((prefix + ".weight", (C,), "one"))
        if bias:
            out.append((prefix + ".bias", (C,), "zero"))

    def linear(prefix, n_out, n_in, init):
        out.append((prefix + ".weight", (n_out, n_in), init))
        if bias:
            out.append((prefix + ".bias", (n_out,), "zero"))

    for i in range(L):
        p = f"transformer.h.{i}."
        ln(p + "ln_1")
        linear(p + "attn.c_attn", C + 2 * KHD, C, "normal")
        linear(p + "attn.c_proj", C, C, "proj")
        ln(p + "ln_2")
        linear(p + "mlp.c_fc", 4 * C, C, "normal")
        linear(p + "mlp.c_proj", C, 4 * C, "proj")
    ln("transformer.ln_f")
    return out


def make(cfg: dict, seed: int, device) -> tuple[torch.Tensor, dict]:
    """(the flat float32 buffer, {name: view}) for ``seed``."""
    order = ("normal", "proj", "one", "zero")
    spec = sorted(leaves(cfg), key=lambda leaf: order.index(leaf[2]))
    sizes = {kind: sum(math.prod(s) for _, s, k in spec if k == kind)
             for kind in order}
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32,
                       device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    n_rand = sizes["normal"] + sizes["proj"]
    flat[:n_rand].normal_(0.0, 0.02, generator=gen)
    flat[sizes["normal"]:n_rand].mul_(1.0 / math.sqrt(2 * cfg["n_layer"]))
    flat[n_rand:n_rand + sizes["one"]].fill_(1.0)
    flat[n_rand + sizes["one"]:].zero_()
    views, at = {}, 0
    for name, shape, _ in spec:
        n = math.prod(shape)
        views[name] = flat[at:at + n].view(shape)
        at += n
    return flat, views
