"""The benchmark's arithmetic: the chip's peaks, the schedule of a windowed
decode, the operations of a decode and of a training step, and the bytes
of one call of the decode attention kernel (K1). Everything here is
counted from shapes; nothing is read from the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def prefill_len(prompt_len: int, window: int) -> int:
    """The decoder's first encode: the prompt capped at the window, rounded
    down to a power of two."""
    n = max(min(prompt_len, window), 1)
    return 1 << (n.bit_length() - 1)


def decode_calls(prompt_len: int, new_tokens: int, window: int,
                 refresh: int) -> list[tuple[str, int]]:
    """The model calls of one windowed generate, in order: ``("prefill",
    T)`` encodes T tokens from position 0 into an empty cache, ``("step",
    pos)`` feeds one token at cache column ``pos`` (its live columns are
    ``0 .. pos``). One step a generated token; a refill of ``window -
    refresh`` tokens each ``refresh`` tokens past the window."""
    total = prompt_len + new_tokens
    first = prefill_len(prompt_len, window)
    calls = [("prefill", first)]
    t = min(total, window)
    calls += [("step", pos) for pos in range(first, t)]
    ctx = window - refresh
    while t < total:
        calls.append(("prefill", ctx))
        n = min(refresh, total - t)
        calls += [("step", ctx + j) for j in range(n)]
        t += n
    return calls


def matmul_params(cfg: dict) -> int:
    """Weights of the matrix products a token passes (four projections a
    layer and the tied head), the N of 2N."""
    C, H, L, V = cfg["n_embd"], cfg["n_head"], cfg["n_layer"], \
        cfg["vocab_size"]
    KHD = (cfg.get("n_kv_head") or H) * (C // H)
    return L * (C * (C + 2 * KHD) + C * C + 8 * C * C) + V * C


def decode_flops(cfg: dict, calls: list[tuple[str, int]]) -> float:
    """Operations (a multiply-add is 2) one row of a generate needs: for a
    fed token 2N and 4 * L * H * D a live column (scores and values); a
    prefill of T tokens runs the layers on all T (causal: token j has j+1
    columns) and the head on its last token only."""
    C, H, L, V = cfg["n_embd"], cfg["n_head"], cfg["n_layer"], \
        cfg["vocab_size"]
    n, head = matmul_params(cfg), V * C
    per_col = 4 * L * H * (C // H)
    flops = 0.0
    for kind, x in calls:
        if kind == "step":
            flops += 2 * n + per_col * (x + 1)
        else:
            flops += 2 * (n - head) * x + 2 * head + per_col * x * (x + 1) / 2
    return flops


def train_flops_per_token(cfg: dict, n_params: int, block: int) -> float:
    """The PaLM estimate nanoGPT's ``estimate_mfu`` uses: 6N + 12 L H D T,
    N the parameters but the position table (the tied head once)."""
    C, H, L = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    return 6 * n_params + 12 * L * H * (C // H) * block


def k1_bytes(batch: int, cfg: dict, pos: int, quantized: bool,
             compute: str = "bfloat16") -> int:
    """Bytes one K1 call must move at cache column ``pos``, each once: the
    live K and V columns ``0 .. pos`` (int8 or the compute type) and, int8,
    their per-(column, kv-head) bf16 scales; q [B, H, D]; the fresh K and V
    projections [B, KH*D] in the compute type; the output [B, H, D]."""
    C, H = cfg["n_embd"], cfg["n_head"]
    KH, D = cfg.get("n_kv_head") or H, C // H
    cb = DTYPE_BYTES[compute]
    cols = pos + 1
    cache = 2 * batch * cols * KH * D * (1 if quantized else cb)
    scales = 2 * batch * KH * cols * 2 if quantized else 0
    return cache + scales + batch * H * D * cb * 2 + 2 * batch * KH * D * cb
