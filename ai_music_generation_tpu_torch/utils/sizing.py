"""Transformer parameter/FLOPs accounting.

Code-form equivalent of the reference's analysis notebooks
(ref: nanoGPT/transformer_sizing.ipynb, scaling_laws.ipynb): exact parameter
breakdown per component, per-token and per-iteration FLOPs (PaLM appendix-B
convention), memory footprints, and tokens/sec projections against the
card's peak.

The port of ``ai_music_generation_tpu/utils/sizing.py`` over the port's
``GPTConfig``: the same counts (tests/test_torch_hf_import.py holds them to
the original's and to the port ``GPT``'s parameters); the projections'
default peak is ``models.gpt.peak_flops_for``'s, the card's (989 TFLOP/s
bf16 on an H100), else the CPU's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ai_music_generation_tpu_torch.models.gpt import GPTConfig, peak_flops_for


@dataclass
class SizingReport:
    params_total: int
    params_non_embedding: int
    breakdown: dict
    flops_per_token: int
    flops_per_fwdbwd_token: int
    checkpoint_bytes: int
    kv_cache_bytes_per_token: int


def params_breakdown(cfg: GPTConfig) -> dict:
    """Exact per-component parameter counts (mirrors the notebook table)."""
    d, L, V, T = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.block_size
    b = 1 if cfg.bias else 0
    # GQA: K/V projections emit kv_heads*head_dim each (== d when full MHA)
    kv = cfg.kv_heads * cfg.head_dim
    out = {
        "wte": V * d,
        "wpe": T * d,
        "ln": L * 2 * (d + b * d) + d + b * d,  # 2 per block + final
        "attn_qkv": L * (d * (d + 2 * kv) + b * (d + 2 * kv)),
        "attn_proj": L * (d * d + b * d),
        "mlp_fc": L * (d * 4 * d + b * 4 * d),
        "mlp_proj": L * (4 * d * d + b * d),
        "lm_head": 0,  # weight-tied to wte
    }
    out["total"] = sum(out.values())
    out["non_embedding"] = out["total"] - out["wpe"]
    return out


def flops_per_token(cfg: GPTConfig, n_params: int) -> int:
    """6N + 12*L*H*Q*T (PaLM appendix B; ref nanoGPT/model.py:289-303)."""
    return 6 * n_params + 12 * cfg.n_layer * cfg.n_head * cfg.head_dim * cfg.block_size


def sizing_report(cfg: GPTConfig) -> SizingReport:
    bd = params_breakdown(cfg)
    n = bd["non_embedding"]
    fpt = flops_per_token(cfg, n)
    # checkpoint: fp32 params + adamw mu/nu
    ckpt = bd["total"] * 4 * 3
    # kv cache per token per sequence: 2 (k,v) * L * kv_width * elem bytes
    # (bf16 = 2; int8 = 1 value byte + bf16 per-head scale). GQA shrinks
    # the width to kv_heads * head_dim.
    kv_width = cfg.kv_heads * cfg.head_dim
    if cfg.kv_quantized:
        kv = 2 * cfg.n_layer * (kv_width + 2 * cfg.kv_heads)
    else:
        kv = 2 * cfg.n_layer * kv_width * 2
    return SizingReport(
        params_total=bd["total"],
        params_non_embedding=n,
        breakdown=bd,
        flops_per_token=fpt,
        flops_per_fwdbwd_token=fpt,
        checkpoint_bytes=ckpt,
        kv_cache_bytes_per_token=kv,
    )


def projected_tokens_per_sec(cfg: GPTConfig, mfu: float = 0.4,
                             peak: float | None = None) -> float:
    """Training tokens/sec at an assumed MFU."""
    rep = sizing_report(cfg)
    return (peak or peak_flops_for()) * mfu / rep.flops_per_token


def print_report(cfg: GPTConfig) -> None:
    rep = sizing_report(cfg)
    print(f"{'component':<16}{'params':>14}")
    for k, v in rep.breakdown.items():
        print(f"{k:<16}{v:>14,}")
    print(f"flops/token (6N+attn): {rep.flops_per_token:,}")
    print(f"checkpoint size: {rep.checkpoint_bytes/1e6:.1f} MB")
    print(f"kv cache/token: {rep.kv_cache_bytes_per_token} bytes")
