"""The port's dropout (``ops/dropout.py``) on the CPU: through
``CounterDropout`` every site's forward and gradient are bit for bit those
of the plain formula ``torch.where(keep, true_divide(x, 1 - p), 0.0)``
under autograd, for a whole site and for a mesh rank's block of one, in the
model with and without ``remat``; and the wrapper's checks on what the CUDA
kernel takes. The kernel itself is held to the same twin on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import types

import pytest
import torch

from ai_music_generation_tpu_torch.models import gpt
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.ops.dropout import (
    CounterDropout,
    dropout_apply,
)

torch.set_num_threads(1)

KEY = gpt.dropout_key(1337, 12, 1)


def _where_formula(x, p, key, layer, site, layout=None, head0=0,
                   n_head=None):
    """``models.gpt.dropout`` as it was written before the kernel: the mask
    of ``dropout_keep``, a division and a where, differentiated by
    autograd."""
    start, full = gpt.site_block(x.shape, layout, head0, n_head)
    keep = gpt.dropout_keep(x.shape, p, key, layer, site, x.device, start,
                            full)
    return torch.where(keep, gpt.true_divide(x, 1.0 - p), 0.0)


# (shape, dropout's mesh arguments): whole sites of the [B, T, C] and the
# attention-probability kind, sizes off the kernel's 8-element vectors; a
# data rank's rows of a site; a rank's rows and heads of the probabilities
SITES = {
    "btc": ((3, 17, 37), ()),
    "probs": ((2, 3, 17, 17), ()),
    "rows": ((3, 5, 24), (types.SimpleNamespace(data_rank=1, n_data=3),)),
    "heads": ((2, 2, 9, 9), (types.SimpleNamespace(data_rank=1, n_data=2),
                             2, 6)),
}


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_counter_dropout_is_the_where_formula(dtype, site, p):
    shape, mesh = SITES[site]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(dtype)
    upstream = torch.randn(shape, generator=g).to(dtype)
    before = dropout_apply.launches
    a, b = (x.clone().requires_grad_() for _ in range(2))
    got = gpt.dropout(a, p, KEY, 2, gpt.SITE_ATTN_PROBS, *mesh)
    want = _where_formula(b, p, KEY, 2, gpt.SITE_ATTN_PROBS, *mesh)
    assert got.dtype == dtype and torch.equal(got, want)
    got.backward(upstream)
    want.backward(upstream)
    assert torch.equal(a.grad, b.grad)
    assert dropout_apply.launches == before  # no kernel on the CPU


def test_counter_dropout_is_linear_to_second_order():
    """Its gradient is the same map over the gradient, itself
    differentiable: gradcheck and gradgradcheck in float64 (the twin)."""
    x = torch.randn((4, 33), dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    fn = lambda t: CounterDropout.apply(t, 0.3, KEY, 1, 2)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


COMMON = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=64,
              n_kv_head=2, bias=False, dropout=0.2)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_model_with_counter_dropout_is_the_where_formula(dtype, remat,
                                                         monkeypatch):
    """A train-mode forward and backward (every site: the embedding sum,
    the probabilities, both outputs of each layer) gives the loss and every
    gradient of the same model over the where formula, bit for bit."""
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, 64, (2, 32), generator=g) for _ in range(2))
    runs = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(gpt, "dropout", _where_formula)
        model = init_weights(
            gpt.GPT(gpt.GPTConfig(**COMMON, dtype=dtype, remat=remat),
                    device="cpu"), torch.Generator().manual_seed(0)).train()
        _, loss = model(x, y, dropout_key=KEY)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in model.parameters()]))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("shape,dtype,p,start,full,match", [
    ((4, 8), torch.float16, 0.2, None, None, "bfloat16 or torch.float32"),
    ((4, 8), torch.float64, 0.2, None, None, "bfloat16 or torch.float32"),
    ((4, 8), torch.bfloat16, 1.5, None, None, "outside"),
    ((1 << 16, 1 << 16), torch.bfloat16, 0.2, None, None, "2\\^32"),
    ((2, 8), torch.float32, 0.2, (0, 0), (1 << 29, 8), "2\\^32"),
    ((1, 1, 1, 1, 2), torch.float32, 0.2, (0,) * 5, (2, 1, 1, 1, 2),
     "at most 4 dims"),
    ((4, 8), torch.bfloat16, 0.2, None, None, "cuda or cpu"),
], ids=["fp16", "fp64", "rate", "site", "mesh-site", "rank", "device"])
def test_wrapper_refuses_what_the_kernel_cannot_take(shape, dtype, p, start,
                                                     full, match):
    """Off the CPU the wrapper checks what the kernel takes and raises,
    never falling back to the twin: a dtype other than bf16 and fp32 (on
    the card as on any device), a rate outside [0, 1], a site of 2^32
    elements or more (the 32-bit counter would wrap), a block of more than
    4 dims, a device other than cuda."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    before = dropout_apply.launches
    with pytest.raises(ValueError, match=match):
        dropout_apply(x, p, KEY, 0, 0, start, full)
    assert dropout_apply.launches == before
