"""The plain reference of the benchmark's GPT configurations: a GPT-2
decoder (pre-LayerNorm blocks, tanh GELU MLP of width 4C, learned
positions, tied head, optional grouped K/V heads), its windowed decoding
as contexts, and three steps of training with global-norm clipping and
AdamW. Plain PyTorch over a dict of float32 tensors named as nanoGPT names
them; it imports nothing of the program under test.

Departures from a textbook GPT-2, each what the configuration states:
query head h reads K/V head ``h // (n_head // n_kv_head)``; a cache stated
as int8 is quantized and dequantized before attention
(``precision.Precision.cache``); dropout uses the frozen counter masks of
``hash32_frozen``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import hash32_frozen
from port_bench.reference.precision import Precision


def _linear(x, w, b, prec: Precision):
    y = prec.mm(x.reshape(-1, x.shape[-1]), w.t())
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:-1], w.shape[0])


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


class Dropout:
    """The masks of one micro-step (``key``) at rate ``p``, for rows
    ``rows`` of a micro-batch of ``batch`` rows."""

    def __init__(self, p: float, key: int, rows: tuple[int, int], batch: int):
        self.p, self.key, self.rows, self.batch = p, key, rows, batch

    def __call__(self, x, layer: int, site: int):
        full = (self.batch, *x.shape[1:])
        keep = hash32_frozen.keep_mask(full, self.rows, self.p, self.key,
                                       layer, site, x.device)
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def forward(w: dict, cfg: dict, idx: torch.Tensor, prec: Precision,
            drop: Optional[Dropout] = None) -> torch.Tensor:
    """Logits [B, T, V] (float32) of tokens ``idx`` [B, T] at positions
    0 .. T-1, causal."""
    B, T = idx.shape
    C, H, L = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    KH = cfg.get("n_kv_head") or H
    D, G = C // H, H // KH
    wte = w["transformer.wte.weight"]
    x = wte[idx] + w["transformer.wpe.weight"][:T]
    if drop is not None:
        x = drop(x, 0, 0)
    causal = torch.ones(T, T, dtype=torch.bool, device=idx.device).tril()
    for i in range(L):
        p = f"transformer.h.{i}."
        h = _ln(x, w[p + "ln_1.weight"], w.get(p + "ln_1.bias"))
        qkv = _linear(h, w[p + "attn.c_attn.weight"],
                      w.get(p + "attn.c_attn.bias"), prec)
        q, k, v = qkv.split([C, KH * D, KH * D], dim=-1)
        k = prec.cache(k.reshape(B, T, KH, D))
        v = prec.cache(v.reshape(B, T, KH, D))
        q = q.reshape(B, T, H, D).transpose(1, 2)
        k = k.transpose(1, 2).repeat_interleave(G, dim=1)
        v = v.transpose(1, 2).repeat_interleave(G, dim=1)
        att = prec.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
        att = att.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        if drop is not None:
            att = drop(att, i, 1)
        y = prec.mm(att, v).transpose(1, 2).reshape(B, T, C)
        y = _linear(y, w[p + "attn.c_proj.weight"],
                    w.get(p + "attn.c_proj.bias"), prec)
        if drop is not None:
            y = drop(y, i, 2)
        x = x + y
        h = _ln(x, w[p + "ln_2.weight"], w.get(p + "ln_2.bias"))
        m = F.gelu(_linear(h, w[p + "mlp.c_fc.weight"],
                           w.get(p + "mlp.c_fc.bias"), prec),
                   approximate="tanh")
        m = _linear(m, w[p + "mlp.c_proj.weight"],
                    w.get(p + "mlp.c_proj.bias"), prec)
        if drop is not None:
            m = drop(m, i, 3)
        x = x + m
    x = _ln(x, w["transformer.ln_f.weight"], w.get("transformer.ln_f.bias"))
    return _linear(x, wte, None, prec)


def decode_contexts(prompt_len: int, total: int, window: int,
                    refresh: int) -> list[tuple[int, int, int]]:
    """How windowed decoding conditions each generated token.

    Tokens ``[prompt_len, total)`` are generated. Up to ``window`` the
    context is every token before, from position 0. Past it the cache is
    refilled: at each ``t = window + m * refresh`` the last ``window -
    refresh`` tokens are encoded again from position 0, and the next
    ``refresh`` tokens are decoded on that context. Returns ``(start, lo,
    hi)`` triples: tokens ``[lo, hi)`` are predicted from the context
    beginning at token ``start`` (position 0)."""
    out = []
    t = min(total, window)
    if t > prompt_len:
        out.append((0, prompt_len, t))
    ctx = window - refresh
    while t < total:
        n = min(refresh, total - t)
        out.append((t - ctx, t, t + n))
        t += n
    return out


@torch.no_grad()
def served_logits(w: dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
                  window: int, refresh: int, prec: Precision):
    """For rows ``tokens`` [R, total] of a windowed decode, the logits
    [R, total - prompt_len, V] that predict each generated token, each
    from the context the decoding gave it."""
    total = tokens.shape[1]
    parts = []
    for start, lo, hi in decode_contexts(prompt_len, total, window, refresh):
        seg = tokens[:, start:hi - 1].long()
        logits = forward(w, cfg, seg, prec)
        parts.append(logits[:, lo - 1 - start:hi - 1 - start])
    return torch.cat(parts, dim=1)


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in
            tensors.items()}


def train_three_steps(w0: dict, cfg: dict, opt: dict,
                      batches: list, schedule: Callable[[int], float],
                      seed: int, prec: Precision, chunk_rows: int,
                      steps: int = 3) -> dict:
    """``steps`` optimizer steps from weights ``w0`` over ``batches[s] =
    (x, y)`` [accum, rows, T]: the mean cross-entropy of each micro-batch
    (dropout keyed by ``hash32_frozen.dropout_key(seed, s, i)``), the
    gradients averaged over the micro-batches, clipped to global norm
    ``opt["grad_clip"]`` (scaled by ``clip / norm`` when the norm is not
    below it), then AdamW (decoupled decay ``lr * wd`` on the leaves of rank
    2 or more; ``eps`` added to ``sqrt(v_hat)``). Each micro-batch runs in
    blocks of ``chunk_rows`` rows.

    Returns ``losses`` (a float a step), ``grad_norms`` (a float a leaf:
    the clipped gradient of step 0), ``change_norms`` (a float a leaf:
    ``|w_steps - w0|``)."""
    params = {k: t.detach().clone().requires_grad_(True)
              for k, t in w0.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], 1e-8
    p_drop = cfg.get("dropout", 0.0)
    losses, grad_norms = [], None
    for s in range(steps):
        x_all, y_all = batches[s]
        accum, rows = x_all.shape[0], x_all.shape[1]
        for t in params.values():
            t.grad = None
        loss = 0.0
        for i in range(accum):
            key = hash32_frozen.dropout_key(seed, s, i)
            for r0 in range(0, rows, chunk_rows):
                r1 = min(rows, r0 + chunk_rows)
                drop = (Dropout(p_drop, key, (r0, r1), rows)
                        if p_drop > 0 else None)
                logits = forward(params, cfg, x_all[i, r0:r1].long(), prec,
                                 drop)
                part = F.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    y_all[i, r0:r1].reshape(-1).long())
                (part * ((r1 - r0) / rows / accum)).backward()
                loss += float(part.detach()) * (r1 - r0) / rows / accum
        losses.append(loss)
        with torch.no_grad():
            grads = {k: t.grad for k, t in params.items()}
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            if float(norm) >= opt["grad_clip"]:
                for g in grads.values():
                    g.mul_(opt["grad_clip"] / norm)
            if s == 0:
                grad_norms = _leaf_norms(grads)
            lr, step = schedule(s), s + 1
            for k, p in params.items():
                g = grads[k]
                if p.dim() >= 2:
                    p.mul_(1.0 - lr * opt["weight_decay"])
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).add_(g * g, alpha=1.0 - b2)
                m_hat = m[k] / (1.0 - b1 ** step)
                v_hat = v[k] / (1.0 - b2 ** step)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    with torch.no_grad():
        change = {k: params[k] - w0[k] for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": _leaf_norms(change)}
