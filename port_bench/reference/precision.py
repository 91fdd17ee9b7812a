"""The arithmetic the reference computes in: float32 with TF32 off (the
reference), or one step below what a configuration states (the control).

- ``fp32``: every product in IEEE float32.
- ``fp8``: the operands of every matrix product (the four projections, the
  two attention products, the head), and in training the gradient that
  flows into each, rounded to float8 e4m3 with one scale a tensor (its
  absolute maximum to 448), then multiplied in float32: the step below the
  bfloat16 compute the configurations state.

A K/V cache of ``cache_bits`` 8 is quantized per (position, kv-head) over
the head size as the configurations state it (absolute maximum over 127,
rounded half to even, scale kept in bfloat16); the control lowers it to 4
bits (over 7).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _MatmulFp8(torch.autograd.Function):
    """``a @ b`` of same-rank operands with both (and, backward, the
    incoming gradient) rounded to float8."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round_fp8(g)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Precision:
    """``matmul`` "fp32" or "fp8"; ``cache_bits`` None (K/V kept as
    computed), 8 or 4."""

    def __init__(self, matmul: str = "fp32", cache_bits: Optional[int] = None):
        if matmul not in ("fp32", "fp8"):
            raise ValueError(f"matmul must be fp32 or fp8, not {matmul!r}")
        if cache_bits not in (None, 8, 4):
            raise ValueError(f"cache_bits must be None, 8 or 4")
        self.matmul, self.cache_bits = matmul, cache_bits

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul == "fp8":
            return _MatmulFp8.apply(a, b)
        return a @ b

    def cache(self, x: torch.Tensor) -> torch.Tensor:
        """K or V [..., D] as the cache holds it, dequantized."""
        if self.cache_bits is None:
            return x
        levels = (1 << (self.cache_bits - 1)) - 1
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-6) / levels
        q = torch.round(x / scale).clamp(-levels, levels)
        return q * scale.to(torch.bfloat16).float()

    def lowered(self) -> "Precision":
        """The control's precision: each stated precision one step down."""
        return Precision("fp8", None if self.cache_bits is None else 4)


@contextlib.contextmanager
def ieee_fp32():
    """Float32 products without TF32 inside the block (matmul and cuDNN),
    restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
