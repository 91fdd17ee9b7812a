"""Chinchilla scaling-law calculators.

Clean-room parity for the reference's ``scaling_laws.ipynb``
(ref: nanoGPT/scaling_laws.ipynb — gpt/chinchilla parameter counts,
Chinchilla FLOPs accounting, the L(N, D) loss surface, and compute-optimal
(N, D) for a FLOP budget, i.e. the paper's "Approach 3"). Formulas are from
Hoffmann et al. 2022 (arXiv:2203.15556); constants are the paper's fitted
values, same as the notebook uses.

Complements utils/sizing.py (which covers transformer_sizing.ipynb: exact
parameter/FLOP breakdowns and throughput projections for OUR GPTConfig).
The port's copy of ``ai_music_generation_tpu/utils/scaling_laws.py``
(pure Python; tests/test_torch_hf_import.py holds the two to each other).
"""

from __future__ import annotations

from dataclasses import dataclass

# Chinchilla "Approach 3" fitted constants (paper eq. 10; ref notebook `L`)
E = 1.69  # irreducible entropy of natural text
A = 406.4
B = 410.7
ALPHA = 0.34
BETA = 0.28


def gpt_params(seq_len: int, vocab_size: int, d_model: int, num_heads: int,
               num_layers: int) -> int:
    """GPT-2-style parameter count (learned positional embeddings, tied LM
    head; ref notebook ``gpt_params``)."""
    ffw_size = 4 * d_model
    embeddings = d_model * vocab_size + d_model * seq_len
    attention = 3 * d_model * (d_model + 1) + d_model * (d_model + 1)
    dense = d_model * (ffw_size + 1) + ffw_size * (d_model + 1)
    layer_norms = 2 * 2 * d_model
    per_block = attention + dense + layer_norms
    return embeddings + num_layers * per_block + 2 * d_model  # final LN


def chinchilla_params(seq_len: int, vocab_size: int, d_model: int,
                      num_heads: int, num_layers: int, ffw_size: int) -> int:
    """Chinchilla-family parameter count: relative positional encodings (no
    learned position table, extra relative-attention projections), untied
    output head (ref notebook ``chinchilla_params``)."""
    embeddings = d_model * vocab_size
    # q, k, v, output projections + relative-position projection
    attention = 3 * d_model * (d_model + 1) + d_model * (d_model + 1)
    relative = d_model * d_model + 2 * num_heads * (d_model // num_heads)
    dense = d_model * (ffw_size + 1) + ffw_size * (d_model + 1)
    layer_norms = 2 * 2 * d_model
    per_block = attention + relative + dense + layer_norms
    head = d_model * vocab_size  # untied
    return embeddings + num_layers * per_block + head


def chinchilla_flops(seq_len: int, vocab_size: int, d_model: int,
                     num_heads: int, num_layers: int, ffw_size: int) -> float:
    """Total training FLOPs per SEQUENCE per the Chinchilla appendix F
    accounting (fwd + bwd = 3x fwd; ref notebook ``chinchilla_flops``)."""
    key_size = d_model // num_heads
    embeddings = 2 * seq_len * vocab_size * d_model
    attention_qkv = 2 * 3 * seq_len * d_model * (key_size * num_heads)
    attention_logits = 2 * seq_len * seq_len * (key_size * num_heads)
    attention_softmax = 3 * num_heads * seq_len * seq_len
    attention_reduce = 2 * seq_len * seq_len * (key_size * num_heads)
    attention_project = 2 * seq_len * (key_size * num_heads) * d_model
    dense = 2 * seq_len * (d_model * ffw_size + d_model * ffw_size)
    final_logits = 2 * seq_len * d_model * vocab_size
    per_layer = (attention_qkv + attention_logits + attention_softmax
                 + attention_reduce + attention_project + dense)
    forward = embeddings + num_layers * per_layer + final_logits
    return 3 * forward  # fwd + 2x bwd


def chinchilla_loss(n_params: float, n_tokens: float) -> float:
    """L(N, D) = E + A/N^alpha + B/D^beta (paper eq. 10; ref notebook ``L``)."""
    return E + A / n_params ** ALPHA + B / n_tokens ** BETA


@dataclass
class OptimalAllocation:
    flops: float
    n_params: float
    n_tokens: float
    loss: float
    tokens_per_param: float


def compute_optimal(flop_budget: float) -> OptimalAllocation:
    """Compute-optimal (N, D) for a FLOP budget C under FLOPs = 6 N D
    (paper "Approach 3" closed form: N* = G (C/6)^{b/(a+b)})."""
    a_exp = BETA / (ALPHA + BETA)
    b_exp = ALPHA / (ALPHA + BETA)
    G = (ALPHA * A / (BETA * B)) ** (1.0 / (ALPHA + BETA))
    n_opt = G * (flop_budget / 6.0) ** a_exp
    d_opt = (1.0 / G) * (flop_budget / 6.0) ** b_exp
    return OptimalAllocation(
        flops=flop_budget, n_params=n_opt, n_tokens=d_opt,
        loss=chinchilla_loss(n_opt, d_opt),
        tokens_per_param=d_opt / n_opt,
    )


def optimal_for_params(n_params: float) -> OptimalAllocation:
    """The compute-optimal token budget for a FIXED model size (invert the
    Approach-3 allocation) — the question the music configs actually ask."""
    a_exp = BETA / (ALPHA + BETA)
    G = (ALPHA * A / (BETA * B)) ** (1.0 / (ALPHA + BETA))
    flops = 6.0 * (n_params / G) ** (1.0 / a_exp)
    return compute_optimal(flops)
