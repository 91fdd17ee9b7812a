"""Counter-hash dropout of one training site: the keep mask of
:func:`dropout_keep` built and applied in one pass.

On a CUDA tensor :func:`dropout_apply` launches the hand-written kernel of
``csrc/dropout.cu`` (the hash in ``csrc/hash32.cuh``); on a CPU tensor it
runs the plain twin :func:`dropout_reference`. Nothing falls back: a CUDA
call that the kernel cannot take raises. :class:`CounterDropout` is the
autograd function around it, and ``models.gpt.dropout`` calls it at every
dropout site of the port (the dense GPT, the MoE experts' output, both
TunesFormer cores, a mesh rank's block of a site).

Contract, for x of any shape (the site, or a block of it):

- element i is kept iff ``mix32(mul32(idx, GOLDEN) ^ k) >= threshold(p)``
  with ``k = site_key(key, layer, site)`` and idx the row-major index of i
  in the site: i itself, or, for the block at ``start`` of a site of shape
  ``full`` (``start`` and ``full`` given, up to 4 dims on the card), the
  index of its coordinates in ``full``. The mask is the port's own
  contract: the JAX package's ``nn.Dropout`` draws a ``jax.random``
  Bernoulli mask, which XLA fuses into its neighbours;
- a kept element is ``x / d`` as one IEEE division rounded to x's dtype,
  ``d`` being 1 - p in x's dtype (the division of
  ``models.gpt.true_divide``); a dropped one is +0;
- the backward is the same map over the gradient: kept ``grad / d``,
  dropped +0, the mask recomputed from the index (nothing is saved, and
  ``remat``'s recompute runs the forward again).

The CUDA kernel takes bf16 and fp32 (the dtypes ``GPTConfig.dtype`` takes),
a site of fewer than 2^32 elements and 0 <= p <= 1; a non-contiguous x is
made contiguous first (and one that does not start on a 16-byte boundary
copied). It raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ai_music_generation_tpu_torch.ops import _build
from ai_music_generation_tpu_torch.utils.hash32 import GOLDEN, mix32, mul32

_DTYPES = (torch.bfloat16, torch.float32)


def site_key(key: int, layer: int, site: int) -> int:
    """The 32-bit key of one site's mask: a hash of the step's ``key``,
    the layer and the site."""
    return mix32(key ^ mul32(layer * 4 + site + 1, GOLDEN))


def threshold(p: float) -> int:
    """Bits at or above ``round(p * 2^32)`` keep their element, so each is
    kept with probability 1 - p (p = 1 gives 2^32 and drops every one)."""
    return round(p * 2.0 ** 32)


def _site(shape, start, full):
    """(start, full) of a block, the whole site's when ``start`` is None;
    raises if the site holds 2^32 elements or more (the 32-bit index would
    wrap)."""
    if start is None:
        start, full = (0,) * len(shape), tuple(shape)
    n = math.prod(full)
    if n >= 1 << 32:
        raise ValueError(f"a dropout site of {n} elements passes 2^32")
    return start, full


def dropout_keep(shape, p: float, key: int, layer: int, site: int,
                 device=None, start=None, full=None) -> torch.Tensor:
    """The keep mask (bool, ``shape``) of one dropout site, the mask of
    record (module docstring), with integer torch ops only: the same bits
    on every device. ``start`` and ``full`` (per dim) make the mask the
    block at ``start`` of the site of shape ``full``: a rank's part of a
    site that a mesh splits."""
    start, full = _site(shape, start, full)
    if tuple(full) == tuple(shape):
        idx = torch.arange(math.prod(full), dtype=torch.int64, device=device)
    else:
        idx, stride = torch.zeros((), dtype=torch.int64, device=device), 1
        for d in reversed(range(len(shape))):
            axis = torch.arange(start[d], start[d] + shape[d],
                                dtype=torch.int64, device=device) * stride
            idx = idx + axis.view([-1] + [1] * (len(shape) - 1 - d))
            stride *= full[d]
    bits = mix32(mul32(idx, GOLDEN) ^ site_key(key, layer, site))
    return (bits >= threshold(p)).view(shape)


def dropout_reference(x: torch.Tensor, p: float, key: int, layer: int,
                      site: int, start=None, full=None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: :func:`dropout_keep`, then
    ``torch.where(keep, x / d, 0)``, dividing by a 0-dim tensor of x's
    dtype as ``models.gpt.true_divide`` does (an IEEE division on every
    device)."""
    keep = dropout_keep(x.shape, p, key, layer, site, x.device, start, full)
    return torch.where(keep, x / x.new_full((), 1.0 - p), 0.0)


@functools.cache
def _divisor(p: float, dtype: torch.dtype) -> float:
    """1 - p in ``dtype``, as ``x.new_full((), 1 - p)`` holds it."""
    return torch.full((), 1.0 - p, dtype=dtype).item()


@functools.cache
def _launcher():
    """The library's C entry point (built at the first call)."""
    return _build.load_library().dropout_apply_launch


def _check_cuda(x: torch.Tensor, p: float, start, full):
    """What the kernel takes (module docstring), checked before the device:
    returns the launcher's mesh argument (None for a whole site)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the dropout kernel takes torch.bfloat16 or "
                         f"torch.float32, got {x.dtype}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout rate {p} is outside [0, 1]")
    start, full = _site(x.shape, start, full)
    whole = tuple(full) == tuple(x.shape)
    if not whole and (x.dim() > 4 or len(start) != x.dim()
                      or len(full) != x.dim()):
        raise ValueError(f"a block of a site has at most 4 dims and a start "
                         f"and full shape of its rank, got {tuple(x.shape)}, "
                         f"{tuple(start)}, {tuple(full)}")
    if x.device.type != "cuda":
        raise ValueError(f"dropout_apply runs on cuda or cpu, not "
                         f"{x.device.type}")
    if whole:
        return None
    pad = 4 - x.dim()
    shape = [1] * pad + list(x.shape)
    start = [0] * pad + list(start)
    full = [1] * pad + list(full)
    stride = [math.prod(full[d + 1:]) for d in range(4)]
    return (ctypes.c_longlong * 12)(*shape, *start, *stride)


def dropout_apply(x: torch.Tensor, p: float, key: int, layer: int, site: int,
                  start=None, full=None) -> torch.Tensor:
    """One dropout site (module docstring): the CUDA kernel for a CUDA
    tensor, the plain twin for a CPU tensor. ``dropout_apply.launches``
    counts kernel launches, forward and backward."""
    if x.device.type == "cpu":
        return dropout_reference(x, p, key, layer, site, start, full)
    mesh = _check_cuda(x, p, start, full)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rc = _launcher()(
        x.data_ptr(), y.data_ptr(), x.numel(), site_key(key, layer, site),
        threshold(p), _divisor(p, x.dtype), x.dtype == torch.float32, mesh,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"dropout kernel launch failed: cudaError {rc}")
    dropout_apply.launches += 1
    return y


dropout_apply.launches = 0


class CounterDropout(torch.autograd.Function):
    """``CounterDropout.apply(x, p, key, layer, site, start, full)``: the
    dropout of :func:`dropout_apply`, whose gradient is the same map over
    the gradient; the forward saves no tensor. Under ``create_graph`` the
    backward is this function again, so it can be differentiated twice."""

    @staticmethod
    def forward(ctx, x, p, key, layer, site, start=None, full=None):
        ctx.site = (p, key, layer, site, start, full)
        return dropout_apply(x, *ctx.site)

    @staticmethod
    def backward(ctx, grad):
        apply = (CounterDropout.apply if torch.is_grad_enabled()
                 else dropout_apply)
        return (apply(grad, *ctx.site),) + (None,) * 6
