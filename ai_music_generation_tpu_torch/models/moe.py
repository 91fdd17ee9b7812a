"""Mixture-of-Experts MLP: the port of ``ai_music_generation_tpu/models/
moe.py`` (``MoEMLP``, JAX :44-125).

Each token is routed to its top-k of E expert MLPs; only those experts'
FLOPs are spent on it. The function is the JAX layer's:

- **Router** (:73-78): an fp32 linear without bias on the fp32 input, then
  softmax. Its products are IEEE fp32 on every device whatever the
  process's TF32 flags (:class:`_IEEELinear`): a TF32 router flips the
  expert choice of near-tied tokens.
- **Top-k with renormalised gates** (:79-80). ``jax.lax.top_k`` breaks ties
  toward the lower index; ``torch.topk`` promises no order, so the choice is
  a stable descending sort.
- **Capacity** (:84-85): ``max(1, ceil(capacity_factor * N * K / E))``,
  at most N.
- **GShard priority** (:89-96): a (token, k) pair's buffer row is the number
  of earlier pairs routed to its expert in (k-major, token) order, so every
  token's first choice is served before any second choice; pairs at or past
  the capacity are dropped and contribute exactly 0 (the token rides the
  residual).
- **Experts** (:107-116): two batched GEMMs in the compute dtype with
  biases and the tanh GELU (Flax's ``nn.gelu`` default); the outputs are
  weighted by the renormalised gate in the compute dtype and summed in fp32.
- **Dropout** at the MLP-output site (:118).
- **Aux loss** (:120-124): ``E * sum_e f_e * p_e``, f the share of the
  pre-capacity selections (no gradient), p the mean probability.

Dispatch and combine go by index: the kept tokens are copied into an
``[E, capacity, C]`` buffer and their outputs gathered back. The JAX layer's
one-hot ``[N, E, capacity]`` dispatch and combine tensors are a TPU idiom
(static shapes, no gathers); at the training protocol (N = 64 x 256,
capacity 10,240) each would hold 671M elements a layer, and the index form
computes the same sums. Every shape depends only on N, so a step never
syncs with the host.

On a (data, model) mesh (``layout``, set by ``parallel/sharding.py``)
the layer routes as the single-card layer routes the global batch: the
capacity counts every rank's tokens, and a pair's buffer row is its
priority among all of them (each rank adds the earlier ranks' and earlier
choices' counts, gathered over the data axis, to its own). Each rank of the
model axis holds ``E / n_model`` experts (expert parallelism, JAX
parallel/mesh.py:67-75): the tokens are replicated over that axis, each
rank runs its experts on their pairs and the combine is summed over the
axis. Routing, the gates and the aux loss are computed on every rank alike;
the aux term is this rank's share, as the loss (``models/gpt.py::
cross_entropy_ignore_index``), with the global f. Inside
:func:`local_routing` a layer on a mesh routes the tokens of its own call
alone: the sharded servers' prefill (every data rank runs the whole wave)
and the ticks that JAX runs under ``shard_map`` over the data axis
(``serve/engine.py``).

Parameters keep the JAX layouts (``w_fc`` [E, C, 4C], ``w_proj``
[E, 4C, C], ``b_fc`` [E, 4C], ``b_proj`` [E, C]); the router is a
``Linear`` (weight [E, C], the JAX kernel transposed).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ai_music_generation_tpu_torch.models.gpt import (
    SITE_MLP_OUT,
    cast_param,
    dropout,
)
from ai_music_generation_tpu_torch.parallel.collectives import (
    all_gather_stack,
    copy_to,
    reduce_from,
)
from ai_music_generation_tpu_torch.utils.device import ieee_fp32


_ROUTE_OVER_DATA = contextvars.ContextVar("route_over_data", default=True)


@contextlib.contextmanager
def local_routing(enabled: bool = True):
    """With ``enabled``, MoE layers on a mesh route their call's tokens as
    a batch of their own (the capacity and the buffer rows count this
    rank's tokens only) inside the block; without, the default, they route
    the global batch of the data axis."""
    token = _ROUTE_OVER_DATA.set(not enabled)
    try:
        yield
    finally:
        _ROUTE_OVER_DATA.reset(token)


class _IEEELinear(torch.autograd.Function):
    """``x @ w.T`` with IEEE fp32 products forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with ieee_fp32():
            return x @ w.t()

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with ieee_fp32():
            return grad @ w, grad.t() @ x


def capacity_of(n_tokens: int, n_expert: int, top_k: int,
                capacity_factor: float) -> int:
    """Rows of each expert's buffer (JAX moe.py:84-85): ceil, so that a
    factor of 1.0 under perfectly balanced routing drops nothing; never
    more than the tokens there are."""
    capacity = max(1, int(math.ceil(capacity_factor * n_tokens * top_k
                                    / n_expert)))
    return min(capacity, n_tokens)


def route(probs: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing of ``probs`` [N, E] under GShard priority: returns
    (gate [N, K] renormalised, expert_idx [N, K], keep [N, K] bool, slot
    [N, K] the pair's buffer row, which is >= capacity where dropped).
    Ties go to the lower expert index, as ``jax.lax.top_k``."""
    N, E = probs.shape
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :top_k], expert_idx[:, :top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    # one row an expert over the pairs in (k-major, token) order, so that
    # the running count is a scan along the contiguous last dimension (a
    # scan down an [K*N, E] column runs E-wide on the card: 1.3 ms a
    # decode step at N = 4096)
    order = expert_idx.t().reshape(1, -1)
    sel = torch.zeros(E, order.shape[1], dtype=torch.int32,
                      device=probs.device).scatter_(0, order, 1)
    pos = (sel.cumsum(1, dtype=torch.int32) - sel).gather(0, order)
    slot = pos.view(top_k, N).t()
    return gate, expert_idx, slot < capacity, slot


def data_priority(expert_idx: torch.Tensor, n_expert: int, layout):
    """[N, K] offsets that turn this rank's buffer rows (``route``'s slot
    over its own tokens) into the rows over the global batch of the data
    axis, and the [K, E] counts of every choice over it: a pair (n, k) of
    expert e comes after every rank's pairs of the earlier choices and the
    earlier ranks' pairs of choice k (k-major, then token order, the global
    tokens being the ranks' in rank order)."""
    K = expert_idx.shape[1]
    counts = torch.zeros(K, n_expert, dtype=torch.int64,
                         device=expert_idx.device).scatter_add_(
        1, expert_idx.t(), torch.ones_like(expert_idx.t()))
    every = all_gather_stack(counts, layout.data_group)  # [n_data, K, E]
    total = every.sum(0)
    others = total - counts  # the other ranks' pairs
    offset = others.cumsum(0) - others + every[:layout.data_rank].sum(0)
    return offset.gather(1, expert_idx.t()).t(), total


class MoEMLP(nn.Module):
    """Drop-in for ``models.gpt.MLP`` when ``config.n_expert > 0``;
    ``forward(x, drop=None, aux=True)`` returns ``(y, aux)``, aux an fp32
    0-dim load-balance term, or None with ``aux=False`` (the forwards whose
    loss does not read it: decode, serving, logits only)."""

    # on a mesh (module docstring): a parallel.mesh.Layout, and the names
    # of the parameters that parallel/sharding.py split over the model axis
    layout, split = None, frozenset()

    def __init__(self, config):
        super().__init__()
        self.config = config
        E, C, dt = config.n_expert, config.n_embd, config.param_dtype
        self.w_fc = nn.Parameter(torch.empty(E, C, 4 * C, dtype=dt))
        self.w_proj = nn.Parameter(torch.empty(E, 4 * C, C, dtype=dt))
        if config.bias:
            self.b_fc = nn.Parameter(torch.zeros(E, 4 * C, dtype=dt))
            self.b_proj = nn.Parameter(torch.zeros(E, C, dtype=dt))
        else:
            self.b_fc = self.b_proj = None
        self.router = nn.Linear(C, E, bias=False, dtype=torch.float32)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """The router's fp32 probabilities [N, E] of the tokens of x."""
        xt = x.reshape(-1, x.shape[-1]).float()
        return torch.softmax(_IEEELinear.apply(xt, self.router.weight), -1)

    def forward(self, x: torch.Tensor, drop=None, aux: bool = True):
        cfg, lay = self.config, self.layout
        B, T, C = x.shape
        E, K = cfg.n_expert, min(cfg.expert_top_k, cfg.n_expert)
        N, dt = B * T, x.dtype
        n_data = 1 if lay is None or not _ROUTE_OVER_DATA.get() \
            else lay.n_data
        probs = self.probs(x)
        capacity = capacity_of(N * n_data, E, K, cfg.capacity_factor)
        gate, expert_idx, keep, slot = route(probs, K, capacity)
        # a pair's row in its expert's buffer: over the global batch its
        # slot decides whether it is kept, its row among this rank's own
        # pairs (< N) places it
        row, rows_per = slot, capacity
        if n_data > 1:
            offset, total = data_priority(expert_idx, E, lay)
            keep, rows_per = slot + offset < capacity, min(capacity, N)
        # this rank's experts: all of them, or E / n_model on a model axis
        experts_split = "w_fc" in self.split
        E_local, e0, mine = self.w_fc.shape[0], 0, keep
        if experts_split:
            e0 = lay.model_rank * E_local
            mine = keep & (expert_idx >= e0) & (expert_idx < e0 + E_local)
            x = copy_to(x, lay.model_group)
            gate = copy_to(gate, lay.model_group)

        # dispatch: kept pair (n, k) fills row expert * rows_per + row;
        # dropped pairs write a spare last row that no expert reads
        rows = torch.where(mine, (expert_idx - e0) * rows_per + row,
                           E_local * rows_per)
        xk = x.reshape(N, 1, C).expand(N, K, C).reshape(N * K, C)
        buf = x.new_zeros(E_local * rows_per + 1, C).index_put(
            (rows.reshape(-1),), xk)
        xe = buf[:-1].view(E_local, rows_per, C)
        h = torch.bmm(xe, cast_param(self.w_fc, dt))
        if self.b_fc is not None:
            h = h + cast_param(self.b_fc, dt)[:, None, :]
        h = F.gelu(h, approximate="tanh")
        ye = torch.bmm(h, cast_param(self.w_proj, dt))
        if self.b_proj is not None:
            ye = ye + cast_param(self.b_proj, dt)[:, None, :]

        # combine: each kept pair's output weighted by its gate (in the
        # compute dtype), summed over k in fp32; a dropped pair weighs 0
        ye = ye.reshape(E_local * rows_per, C)
        weight = torch.where(mine, gate, 0.0).to(dt)
        out = torch.where(mine, rows, 0)
        y = None
        for k in range(K):
            term = weight[:, k, None].float() * ye[out[:, k]].float()
            y = term if y is None else y + term
        if experts_split:
            y = reduce_from(y, lay.model_group)
        y = y.to(dt).reshape(B, T, C)
        if drop is not None:
            y = dropout(y, *drop, SITE_MLP_OUT, lay)
        if not aux:
            return y, None

        # load balance (Switch eq. 4): f from the pre-capacity selections
        if n_data > 1:
            f = total.sum(0).float() / (N * n_data) / K
        else:
            counts = torch.zeros(N, E, device=x.device).scatter_add_(
                1, expert_idx, torch.ones(N, K, device=x.device))
            f = counts.mean(0) / K
        return y, E * (f * probs.mean(0)).sum()
