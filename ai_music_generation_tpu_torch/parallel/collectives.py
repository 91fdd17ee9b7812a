"""Autograd-aware collectives of the tensor- and expert-parallel forward
(Megatron's f and g): XLA inserts these by itself under GSPMD, PyTorch
needs them written. Activations between blocks are replicated over the
model axis; a rank-divergent region (its heads, its MLP columns, its
experts, its vocab slice) starts with :func:`copy_to` and ends with
:func:`reduce_from`, so every replicated tensor gets the same, whole
gradient on every rank of the axis.

:func:`ring_shift` is the differentiable ``jax.lax.ppermute`` around a
ring that the sequence-parallel attention (``ops/ring_attention.py``) and
the pipeline schedule (``parallel/pipeline.py``) rotate their blocks with.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """Every rank's slab concatenated on the last dim (rank order) forward;
    backward this rank's slice of the gradient, summed over the group first
    when the ranks used the gathered tensor differently."""

    @staticmethod
    def forward(ctx, x, group, sum_grad):
        ctx.group, ctx.sum_grad = group, sum_grad
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.sum_grad:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=-1)[r].contiguous(), None, None


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to group rank ``(i + shift) % n``, the tensor of rank
    ``(i - shift) % n`` received, in one ``batch_isend_irecv`` (every send
    and receive posted before any waits, so no pair of ranks deadlocks).
    The identity on a group of one (NCCL cannot send to itself)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """:func:`_shift` forward; backward the gradient shifted the other way
    (the transpose of a permutation is its inverse, as JAX transposes
    ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank i of ``group`` gets rank ``(i - shift) % n``'s ``x``
    (differentiable; ranks are the group's, mapped to global ranks for the
    sends)."""
    return _RingShift.apply(x, group, shift)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_last(x: torch.Tensor, group, sum_grad: bool) -> torch.Tensor:
    return _GatherLast.apply(x, group, sum_grad)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` in rank order (no gradient)."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(n, *x.shape)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group in place (no gradient)."""
    dist.all_reduce(x, op=op, group=group)
    return x
