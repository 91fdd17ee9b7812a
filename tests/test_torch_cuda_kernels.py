"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import copy
import functools
import types

import pytest
import torch

from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.decode.speculative import (
    SpecGenerator,
    keep_committed,
    reset_spec_cache,
)
from ai_music_generation_tpu_torch.experiments import int4_kernel_probe
from ai_music_generation_tpu_torch.models import gpt as gpt_module
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    KVCache,
    quantize_int8,
)
from ai_music_generation_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
    decode_attention_int8,
    decode_attention_int8_multirow,
    decode_attention_int8_reference,
)
from ai_music_generation_tpu_torch.ops.dropout import (
    dropout_apply,
    dropout_reference,
)
from ai_music_generation_tpu_torch.ops.gqa_decode import (
    gqa_decode_reference,
    gqa_decode_update,
)
from ai_music_generation_tpu_torch.ops.lean_attention import (
    MAX_S,
    lean_attention,
    lean_attention_reference,
    pack_int4,
)
from ai_music_generation_tpu_torch.ops.spec_attention import (
    _quantize_rows,
    spec_attention,
    spec_attention_int8_dots_reference,
    spec_attention_reference,
    spec_attention_update,
    write_slab,
)
from ai_music_generation_tpu_torch.train.optimizer import (
    adamw_count,
    make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

H, KH, D = 6, 2, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(quant, ring, pos, B, S, seed=0, KH=KH):
    g = torch.Generator().manual_seed(seed)
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)  # noqa
    k_scale = v_scale = mask_rel = None
    if quant:
        k, v = (torch.randint(-127, 128, (B, S, KH * D), generator=g,
                              dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((B, KH, S), generator=g) * 0.1
                             + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, KH * D), bf(B, S, KH * D)
    if ring:
        lengths = torch.randint(0, S, (B,), generator=g)
        offset = (pos - torch.arange(S)) % S
        mask_rel = (lengths[:, None] - offset[None, :]).to(torch.int32)
    return [bf(B, H, D), k, v, bf(B, KH * D), bf(B, KH * D), k_scale,
            v_scale, mask_rel]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_heads", [KH, H], ids=["gqa", "mha"])
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gqa_decode_kernel_matches_twin(cuda, quant, ring, kv_heads):
    """K1 in all four modes, for G = 3 and G = 1 (MHA), pos from 0 to S-1
    (ring mode wraps through both ends), S from one staged tile of columns
    to eight (S=1024, the default block_size); at G = 1 also 30 rows (B=5),
    not a multiple of the 4 rows a block of gqa_decode_mha.cuh, and one row
    over S=1024, whose columns 4 warps split: caches and scales
    bit-exact, the output within one bf16 ulp of its range of the twin in
    fp32."""
    for B, S in ((8, 32), (3, 77), (64, 128), (3, 256), (3, 1024), (5, 32),
                 (1, 1024)):
        for pos in (0, 5, 8, S - 1):
            cpu = _inputs(quant, ring, pos, B, S, KH=kv_heads)
            gpu = [None if a is None else a.to(cuda) for a in cpu]
            # the twin evaluated in fp32, the kernel's own precision: q and
            # the slabs upcast exactly, fresh copies of the caches
            cpu32 = [None if a is None else
                     (a.float() if i in (0, 3, 4) else a.clone())
                     for i, a in enumerate(cpu)]
            pos_cpu = torch.tensor(pos, dtype=torch.int32)
            before = gqa_decode_update.launches
            out = gqa_decode_update(*gpu, pos_cpu.to(cuda))
            assert gqa_decode_update.launches == before + 1
            gqa_decode_update(*cpu, pos_cpu)  # the bf16 twin: cache writes
            ref32 = gqa_decode_reference(*cpu32, pos_cpu)
            torch.cuda.synchronize()
            for got, want in zip(gpu[1:], cpu[1:]):  # caches, scales: exact
                if got is not None:
                    assert torch.equal(got.cpu(), want)
            # the kernel rounds its fp32 result once, to bf16: within one
            # bf16 ulp of the output's largest value (the bf16 twin itself
            # can sit several % of the range away on these sharp random
            # int8 caches, so it is not the yardstick for the output)
            err = (out.float().cpu() - ref32).abs().max()
            assert err <= 2.0 ** -7 * ref32.abs().max(), (B, S, pos, err)


def _ring_rolled(x, shift):
    """The same ring rows with every column moved ``shift`` places on (the
    caches, scales and mask rolled along S), fresh copies."""
    out = [None if a is None else a.clone() for a in x]
    for i in (1, 2, 7):
        out[i] = x[i].roll(shift, dims=1).contiguous()
    for i in (5, 6):
        if x[i] is not None:
            out[i] = x[i].roll(shift, dims=2).contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gqa_decode_mha_ring_keeps_the_window_order(cuda, quant):
    """K1 at G = 1 (csrc/gqa_decode_mha.cuh) in ring mode sums each row's
    window oldest first on the card: the same rows at another cursor (every
    column rolled along the ring) give the same output bits, and rows whose
    window starts at column 0 give the lockstep output's bits; over one
    tile (S=32), four (S=128) and 32 tiles split over 4 warps (B=1,
    S=1024)."""
    for B, S in ((5, 32), (3, 128), (1, 1024)):
        for pos in (0, 5, S - 1):
            x = [None if a is None else a.to(cuda)
                 for a in _inputs(quant, True, pos, B, S, KH=H)]
            p = lambda c: torch.tensor(c % S, dtype=torch.int32,  # noqa
                                       device=cuda)
            want = gqa_decode_update(*_ring_rolled(x, 0), p(pos))
            for shift in (1, 9, S - 6):
                got = gqa_decode_update(*_ring_rolled(x, shift),
                                        p(pos + shift))
                assert torch.equal(got, want), (B, S, pos, shift)
            lock = _ring_rolled(x, 0)
            lock[7] = None
            ring = _ring_rolled(x, 0)
            cols = torch.arange(S, dtype=torch.int32, device=cuda)
            ring[7] = (pos - (pos - cols) % S).expand(B, S).contiguous()
            assert torch.equal(gqa_decode_update(*ring, p(pos)),
                               gqa_decode_update(*lock, p(pos))), (B, S, pos)


@pytest.mark.cuda
def test_gqa_decode_kernel_refuses_what_it_cannot_take(cuda):
    args = [None if a is None else a.to(cuda)
            for a in _inputs(False, False, 0, 4, 16)]
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="q must be"):
        gqa_decode_update(args[0].float(), *args[1:], pos)
    with pytest.raises(ValueError, match="contiguous"):
        k = args[1].transpose(0, 1).contiguous().transpose(0, 1)
        gqa_decode_update(args[0], k, *args[2:], pos)
    with pytest.raises(ValueError, match="pos must be"):
        gqa_decode_update(*args, pos.long())
    with pytest.raises(ValueError, match="16-byte"):
        k = torch.empty(args[1].numel() + 1, dtype=args[1].dtype,
                        device=cuda)[1:].view(args[1].shape)
        gqa_decode_update(args[0], k, *args[2:], pos)
    # head sizes the kernel does not take: not a multiple of 16, or not a
    # divisor of 128
    for D in (24, 96):
        q = torch.zeros((4, 2, D), dtype=torch.bfloat16, device=cuda)
        kv = torch.zeros((4, 16, D), dtype=torch.bfloat16, device=cuda)
        slab = torch.zeros((4, D), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head size"):
            gqa_decode_update(q, kv, kv.clone(), slab, slab, None, None, None,
                              pos)
    # an S whose scores, scales and validity (G + 3 floats a column) pass
    # one block's shared memory: the launcher refuses before any launch
    before = gqa_decode_update.launches
    big = [None if a is None else a.to(cuda)
           for a in _inputs(False, False, 0, 2, 16384)]
    with pytest.raises(ValueError, match="shared memory"):
        gqa_decode_update(*big, pos)
    assert gqa_decode_update.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(kv_quantized=True, n_kv_head=2),
    dict(kv_quantized=False, n_kv_head=2),
    dict(kv_quantized=True, n_kv_head=None),
    dict(kv_quantized=False, n_kv_head=None),
    dict(block_size=1024, n_head=12, n_embd=768, bias=True),
], ids=["int8-kh2", "bf16-kh2", "int8-mha", "bf16-mha", "default-1k"])
def test_model_decode_on_cuda_matches_cpu(cuda, variant):
    """Prefill + 12 teacher-forced decode steps of a 2-layer model at the
    bench widths, and at GPTConfig's default widths and block_size (1024:
    K1 at MHA over a 1024-column bf16 cache): bf16 logits on the card
    within 2^-4 of their range of the CPU's (8 bf16 ulps at the largest
    logit), and one kernel launch per layer per step."""
    cfg = GPTConfig(**{**dict(block_size=64, vocab_size=128, n_layer=2,
                              n_head=6, n_embd=384, bias=False), **variant})
    cpu_model = init_weights(GPT(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    gpu_model = GPT(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, 128, (16, 20), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    caches = (KVCache.create(cfg, 16, device=cuda),
              KVCache.create(cfg, 16, device="cpu"))
    before = gqa_decode_update.launches
    with torch.inference_mode():
        for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 20)]:
            got, _ = gpu_model(ids[:, lo:hi].to(cuda), cache=caches[0])
            want, _ = cpu_model(ids[:, lo:hi], cache=caches[1])
            want = want.float()
            err = (got.float().cpu() - want).abs().max()
            assert err <= 2.0 ** -4 * want.abs().max(), (lo, err)
    assert gqa_decode_update.launches - before == cfg.n_layer * 12
    assert int(caches[0].length) == 20


def _spec_inputs(quant, T, cursor, B, S, H, D, seed=0, dead_row=False):
    """CPU tensors for one verify call (the operands of
    spec_attention_update): ragged live histories outside the write window,
    a tenth of them killed, the T fresh columns at ``cursor``, every other
    column dead (tests/test_torch_spec_attention.py::make_inputs).
    ``dead_row`` adds a row B (B + 1 rows in all) whose every column is
    dead."""
    g = torch.Generator().manual_seed(seed)
    B += dead_row
    HD, Tw = H * D, -(-T // 8) * 8
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)  # noqa
    hist = torch.cat([torch.arange(cursor), torch.arange(cursor + Tw, S)])
    nvalid = torch.randint(0, S - Tw + 1, (B,), generator=g)
    rank = torch.arange(len(hist))
    col_pos = torch.full((B, S), KVCache.INVALID_POS, dtype=torch.int64)
    col_pos[:, hist] = torch.where(rank[None] < nvalid[:, None], rank[None],
                                   KVCache.INVALID_POS)
    col_pos[torch.rand((B, S), generator=g) < 0.1] = KVCache.INVALID_POS
    col_pos[:, cursor:cursor + T] = nvalid[:, None] + torch.arange(T)
    if dead_row:  # the added row reads nothing
        col_pos[-1] = KVCache.INVALID_POS
    if quant:
        k, v, k_slab, v_slab = (torch.randint(
            -127, 128, (B, n, HD), generator=g, dtype=torch.int8)
            for n in (S, S, Tw, Tw))
        k_scale, v_scale = ((torch.rand((B, H, S), generator=g) * 0.02
                             + 0.002).to(torch.bfloat16) for _ in range(2))
    else:
        k, v, k_slab, v_slab = bf(B, S, HD), bf(B, S, HD), bf(B, Tw, HD), \
            bf(B, Tw, HD)
        k_scale = v_scale = None
    return dict(q=bf(B, T, HD), k=k, v=v, k_slab=k_slab, v_slab=v_slab,
                k_scale=k_scale, v_scale=v_scale,
                col_pos=col_pos.to(torch.int32),
                lengths=nvalid.to(torch.int32),
                cursor=torch.tensor(cursor, dtype=torch.int32))


ATT = ("q", "k", "v", "k_scale", "v_scale", "col_pos", "lengths")
UPD = ("q", "k", "v", "k_slab", "v_slab", "k_scale", "v_scale", "col_pos",
       "lengths", "cursor")


def _on(x, device):
    return {n: None if a is None else a.to(device) for n, a in x.items()}


def _spec_fp32_twin(x, n_head, int8_dots):
    """The twin evaluated in fp32 (q upcast exactly), the kernel's own
    precision; the caches are read as given."""
    args = [x[n] for n in ATT]
    args[0] = args[0].float()
    twin = (spec_attention_int8_dots_reference if int8_dots
            else spec_attention_reference)
    return twin(*args, n_head=n_head)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_dots",
                                  "int8_dots_fp32"])
@pytest.mark.parametrize("write", [False, True], ids=["k3", "k2"])
def test_spec_attention_kernel_matches_twin(cuda, write, mode):
    """K2 (write + attention) and K3 (attention) against the twins, at
    both regimes of the tensor-core kernel and their edges (T <= 16 verify,
    T > 16 refresh tiles of 64 queries; over the S=1024 cache the refresh
    takes 16-query tiles, several per (row, head), since 64 rows of scores
    do not fit shared memory), with an added row B whose every column is
    dead (output 0): the slab write bit-exact; the B rows' output within
    one bf16 ulp of its range of the twin evaluated in fp32 (2^-7), 2^-6 in
    int8_dots mode (the kernel and the twin may round a quantized
    probability to neighbouring integers), with a bf16 q and with a full
    fp32 one (int8_dots_fp32). Then spec_trace's verify shape at a small
    batch: B=8, S=256, T=8 at cursor S-8, every row reading the 248 history
    columns."""
    quant, dots = mode != "bf16", mode.startswith("int8_dots")
    make = _spec_inputs32 if mode == "int8_dots_fp32" else functools.partial(
        _spec_inputs, dead_row=True)
    shapes = [(B, S, H, D, T, None)
              for B, S, H, D in ((3, 64, 6, 64), (3, 256, 6, 64),
                                 (8, 256, 6, 64), (2, 32, 2, 16),
                                 (2, 128, 2, 128), (2, 72, 4, 32),
                                 (3, 1024, 6, 64))
              for T in (1, 5, 7, 8, 13, 16, 17, 64, 65, 128)]
    shapes.append((8, 256, 6, 64, 8, 248))  # spec_trace's verify step
    for B, S, H, D, T, n_live in shapes:
        Tw = -(-T // 8) * 8
        if Tw > S:
            continue
        cursors = sorted({c for c in (0, 8, S - Tw) if c <= S - Tw})
        for cursor in cursors if write and n_live is None else (S - Tw,):
            cpu = make(quant, T, cursor, B, S, H, D, seed=T)
            if n_live is not None:  # every live row reads n_live columns
                cpu["lengths"][:-1] = n_live
                cpu["col_pos"][:-1] = KVCache.INVALID_POS
                cpu["col_pos"][:-1, :n_live] = torch.arange(n_live)
                cpu["col_pos"][:-1, cursor:cursor + T] = (
                    n_live + torch.arange(T))
            gpu = _on(cpu, cuda)
            if write:
                before = spec_attention_update.launches
                out = spec_attention_update(
                    *[gpu[n] for n in UPD], n_head=H, int8_dots=dots)
                assert spec_attention_update.launches == before + 1
                write_slab(cpu["k"], cpu["v"], cpu["k_slab"],
                           cpu["v_slab"], cursor)
            else:
                before = spec_attention.launches
                out = spec_attention(*[gpu[n] for n in ATT], n_head=H,
                                     int8_dots=dots)
                assert spec_attention.launches == before + 1
            torch.cuda.synchronize()
            for n in ("k", "v"):  # the write, bit for bit
                assert torch.equal(gpu[n].cpu(), cpu[n]), (n, B, T)
            ref = _spec_fp32_twin(cpu, H, dots)[:-1]
            out = out.float().cpu()
            assert torch.equal(out[-1], torch.zeros_like(out[-1]))
            err = (out[:-1] - ref).abs().max()
            tol = 2.0 ** (-6 if dots else -7) * ref.abs().max()
            assert err <= tol, (B, S, T, cursor, n_live, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_dots"])
def test_spec_attention_kernel_dead_query_reads_nothing(cuda, mode):
    """A query whose every column is dead gets 0, never NaN; poisoned dead
    columns change nothing."""
    quant, dots = mode != "bf16", mode == "int8_dots"
    x = _on(_spec_inputs(quant, 5, 56, 4, 64, 6, 64), cuda)
    x["col_pos"][0] = KVCache.INVALID_POS
    out = spec_attention(*[x[n] for n in ATT], n_head=6, int8_dots=dots)
    dead = x["col_pos"] == KVCache.INVALID_POS
    poison = 127 if quant else float("nan")
    x["k"][dead], x["v"][dead] = poison, poison
    again = spec_attention(*[x[n] for n in ATT], n_head=6, int8_dots=dots)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_spec_attention_kernel_refuses_what_it_cannot_take(cuda):
    x = _on(_spec_inputs(False, 5, 8, 2, 32, 6, 64), cuda)
    args = lambda **kw: [kw.get(n, x[n]) for n in UPD]  # noqa: E731
    with pytest.raises(ValueError, match="q must be"):
        spec_attention_update(*args(q=x["q"].float()), n_head=6)
    with pytest.raises(ValueError, match="contiguous"):
        k = x["k"].transpose(0, 1).contiguous().transpose(0, 1)
        spec_attention_update(*args(k=k), n_head=6)
    with pytest.raises(ValueError, match="cursor must be"):
        spec_attention_update(*args(cursor=x["cursor"].long()), n_head=6)
    with pytest.raises(ValueError, match="k_slab must be"):
        spec_attention_update(*args(k_slab=x["k_slab"][:, :5].contiguous()),
                              n_head=6)
    with pytest.raises(ValueError, match="int8 cache"):
        spec_attention_update(*args(), n_head=6, int8_dots=True)
    with pytest.raises(ValueError, match="head size"):
        spec_attention_update(*args(), n_head=4)  # D = 96
    with pytest.raises(ValueError, match="16-byte"):
        k = torch.empty(x["k"].numel() + 1, dtype=x["k"].dtype,
                        device=cuda)[1:].view(x["k"].shape)
        spec_attention_update(*args(k=k), n_head=6)
    # an S whose score rows pass one block's shared memory: the launcher
    # refuses before any launch, and the cache is not written
    big = _on(_spec_inputs(False, 5, 8, 1, 16384, 6, 64), cuda)
    k0, before = big["k"].clone(), spec_attention_update.launches
    with pytest.raises(ValueError, match="shared memory"):
        spec_attention_update(*[big[n] for n in UPD], n_head=6)
    assert spec_attention_update.launches == before
    assert torch.equal(big["k"], k0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_spec_model_on_cuda_matches_cpu(cuda, quant):
    """The spec-mode model at the bench widths (2 layers): a 7-token
    prefill, three T=5 verify steps with scripted rejections, a refresh
    re-prefill of 32 tokens; bf16 logits on the card within 2^-4 of their
    range of the CPU's, and one kernel launch per layer per call."""
    cfg = GPTConfig(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                    n_embd=384, bias=False, kv_quantized=quant)
    cpu_model = init_weights(GPT(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    gpu_model = GPT(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    g = torch.Generator().manual_seed(1)
    B = 16
    caches = (KVCache.create(cfg, B, device=cuda, spec=True),
              KVCache.create(cfg, B, device="cpu", spec=True))
    calls = [7, 5, 5, 5, "refresh", 32]
    before = spec_attention_update.launches
    with torch.inference_mode():
        for T in calls:
            if T == "refresh":
                for c in caches:
                    reset_spec_cache(c)
                continue
            ids = torch.randint(0, 128, (B, T), generator=g, dtype=torch.int32)
            c0 = [(c.cursor.clone(), c.length.clone()) for c in caches]
            got, _ = gpu_model(ids.to(cuda), cache=caches[0],
                               return_all_logits=True)
            want, _ = cpu_model(ids, cache=caches[1], return_all_logits=True)
            want = want.float()
            err = (got.float().cpu() - want).abs().max()
            assert err <= 2.0 ** -4 * want.abs().max(), (T, err)
            if T == 5:
                commits = torch.randint(1, T + 1, (B,), generator=g,
                                        dtype=torch.int32)
                for c, (cursor0, length0) in zip(caches, c0):
                    keep_committed(c, cursor0, length0,
                                   commits.to(c.length.device), T)
    assert spec_attention_update.launches - before == cfg.n_layer * 5
    assert torch.equal(caches[0].col_pos.cpu(), caches[1].col_pos)
    assert int(caches[0].cursor) == 32


@pytest.mark.cuda
def test_spec_generator_on_cuda_goes_through_the_kernel(cuda):
    cfg = GPTConfig(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                    n_embd=384, bias=False, kv_quantized=True)
    model = init_weights(GPT(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    prompts = torch.randint(0, 128, (32, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    calls = []
    handle = model.register_forward_pre_hook(
        lambda _, args: calls.append(args[0].shape[1]))
    before = spec_attention_update.launches
    out, n_steps = SpecGenerator(model, max_new_tokens=100).generate_with_stats(
        prompts, seed=3)
    handle.remove()
    assert out.shape == (32, 108) and torch.equal(out[:, :8].cpu(), prompts)
    assert calls[0] == 7 and calls.count(5) == n_steps
    assert spec_attention_update.launches - before == cfg.n_layer * len(calls)


def _prefix_inputs(B, S, H, D, length, cache_dtype, seed=0):
    """CPU operands of one valid-prefix decode call (K4: q and cache in
    ``cache_dtype``; int8: bf16 q, int8 cache, fp32 scales [B, S]), every
    column from ``length`` on poisoned: NaN in the float cache, 127 and NaN
    scales in the int8 one. Returns (q, k, v, k_scale, v_scale)."""
    g = torch.Generator().manual_seed(seed)
    HD = H * D
    if cache_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (B, S, HD), generator=g,
                              dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = (torch.rand((B, S), generator=g) * 0.02 + 0.002
                            for _ in range(2))
        k[:, length:], v[:, length:] = 127, 127
        k_scale[:, length:], v_scale[:, length:] = float("nan"), float("nan")
        return (torch.randn((B, HD), generator=g).to(torch.bfloat16), k, v,
                k_scale, v_scale)
    q, k, v = (torch.randn(shape, generator=g).to(cache_dtype)
               for shape in ((B, HD), (B, S, HD), (B, S, HD)))
    k[:, length:], v[:, length:] = float("nan"), float("nan")
    return q, k, v, None, None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_decode_attention_kernel_matches_twin(cuda, dtype):
    """K4 against the twin evaluated in fp32 (inputs upcast exactly): finite
    with a NaN-poisoned tail, within one bf16 ulp of the output's range
    (2^-7) in bf16, 1e-5 of it in fp32."""
    for B, S, H, D in ((3, 256, 6, 64), (256, 256, 6, 64), (5, 40, 2, 16),
                       (4, 96, 3, 128), (2, 64, 4, 32)):
        for length in (1, 7, 63, 64, 100, S - 1, S, S + 9):
            L = min(length, S)
            q, k, v, _, _ = _prefix_inputs(B, S, H, D, L, dtype, seed=length)
            n = torch.tensor(length, dtype=torch.int32, device=cuda)
            before = decode_attention.launches
            out = decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), n,
                                   n_head=H)
            assert decode_attention.launches == before + 1
            torch.cuda.synchronize()
            ref = decode_attention_reference(q.float(), k.float(), v.float(),
                                             length, n_head=H)
            out = out.float().cpu()
            assert out.dtype == ref.dtype and torch.isfinite(out).all()
            tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
                * ref.abs().max()
            assert (out - ref).abs().max() <= tol, (B, S, H, D, length)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["k5", "k6-r1", "k6-r8"])
def test_decode_attention_int8_kernels_match_twin(cuda, variant):
    """K5 and K6 against the twin evaluated in fp32 (q upcast exactly):
    finite with 127s and NaN scales past ``length``, within one bf16 ulp of
    the output's range."""
    for B, S, H, D in ((16, 256, 6, 64), (256, 256, 6, 64), (8, 48, 2, 16),
                       (8, 64, 3, 128)):
        for length in (1, 15, 127, 128, 200, S):
            L = min(length, S)
            q, k, v, ks, vs = _prefix_inputs(B, S, H, D, L, torch.int8,
                                             seed=length)
            dev = [t.to(cuda) for t in (q, k, v, ks, vs)]
            n = torch.tensor(length, dtype=torch.int32, device=cuda)
            if variant == "k5":
                fn = decode_attention_int8
                out = fn(*dev[:3], dev[3].reshape(B, 1, S),
                         dev[4].reshape(B, 1, S), n, n_head=H)
            else:
                fn = decode_attention_int8_multirow
                rows = int(variant[-1])
                before = fn.launches
                out = fn(*dev, n, n_head=H, rows_per_program=rows)
                assert fn.launches == before + 1
            torch.cuda.synchronize()
            ref = decode_attention_int8_reference(q.float(), k, v, ks, vs,
                                                  length, n_head=H)
            out = out.float().cpu()
            assert torch.isfinite(out).all()
            assert (out - ref).abs().max() <= 2.0 ** -7 * ref.abs().max(), (
                B, S, H, D, length)


@pytest.mark.cuda
def test_decode_attention_kernels_refuse_what_they_cannot_take(cuda):
    q, k, v, _, _ = (None if t is None else t.to(cuda)
                     for t in _prefix_inputs(4, 32, 6, 64, 32, torch.bfloat16))
    n = torch.tensor(32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        decode_attention(q.half(), k.half(), v.half(), n, n_head=6)
    with pytest.raises(ValueError, match="k must be"):
        decode_attention(q, k.float(), v, n, n_head=6)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, n, n_head=6)
    with pytest.raises(ValueError, match="length must be"):
        decode_attention(q, k, v, n.long(), n_head=6)
    with pytest.raises(ValueError, match="length must be a tensor"):
        decode_attention(q, k, v, 32, n_head=6)
    with pytest.raises(ValueError, match="head size"):
        decode_attention(q, k, v, n, n_head=4)  # D = 96
    with pytest.raises(ValueError, match="16-byte"):
        k_off = torch.empty(k.numel() + 1, dtype=k.dtype,
                            device=cuda)[1:].view(k.shape)
        decode_attention(q, k_off, v, n, n_head=6)
    q8, k8, v8, ks, vs = (t.to(cuda) for t in
                          _prefix_inputs(6, 32, 6, 64, 32, torch.int8))
    with pytest.raises(ValueError, match="k_scale must be"):
        decode_attention_int8(q8, k8, v8, ks, vs, n, n_head=6)  # [B, S]
    with pytest.raises(ValueError, match="must divide batch"):
        decode_attention_int8_multirow(q8, k8, v8, ks, vs, n, n_head=6,
                                       rows_per_program=4)
    with pytest.raises(ValueError, match="q must be"):
        decode_attention_int8_multirow(q8.float(), k8, v8, ks, vs, n,
                                       n_head=6, rows_per_program=2)


PALLAS_SMALL = dict(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                    n_embd=384, bias=False, attn_impl="pallas")


@pytest.mark.cuda
def test_pallas_model_on_cuda_matches_cpu(cuda):
    """The attn_impl="pallas" model (MHA, bf16 cache) at the bench widths,
    2 layers: prefill + 12 decode steps, bf16 logits on the card within 2^-4
    of their range of the CPU's; every step launches K4 once per layer and
    K1 never."""
    cfg = GPTConfig(**PALLAS_SMALL)
    cpu_model = init_weights(GPT(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    gpu_model = GPT(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, 128, (16, 20), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    caches = (KVCache.create(cfg, 16, device=cuda),
              KVCache.create(cfg, 16, device="cpu"))
    k4, k1 = decode_attention.launches, gqa_decode_update.launches
    with torch.inference_mode():
        for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 20)]:
            got, _ = gpu_model(ids[:, lo:hi].to(cuda), cache=caches[0])
            want, _ = cpu_model(ids[:, lo:hi], cache=caches[1])
            want = want.float()
            err = (got.float().cpu() - want).abs().max()
            assert err <= 2.0 ** -4 * want.abs().max(), (lo, err)
    assert decode_attention.launches - k4 == cfg.n_layer * 12
    assert gqa_decode_update.launches == k1


@pytest.mark.cuda
def test_pallas_generator_on_cuda_launches_k4_only(cuda):
    """A Generator run (window 64: 56 steps, a refresh, 32 steps, a refresh,
    12 steps) launches K4 n_layer x 100 times and K1 none."""
    model = init_weights(GPT(GPTConfig(**PALLAS_SMALL), device="cpu"),
                         torch.Generator().manual_seed(0)).to(cuda).eval()
    prompts = torch.randint(0, 128, (32, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    k4, k1 = decode_attention.launches, gqa_decode_update.launches
    out = Generator(model, max_new_tokens=100).generate(prompts, seed=3)
    torch.cuda.synchronize()
    assert out.shape == (32, 108) and torch.equal(out[:, :8].cpu(), prompts)
    assert decode_attention.launches - k4 == 2 * 100
    assert gqa_decode_update.launches == k1


def _lean_inputs(packed, B, S, H, D, seed=0):
    """CPU operands of one lean_attention call: bf16 normal q [B, HD]; an
    int8 cache [B, S, HD] over the full range, or a position-packed int4
    one [B, S/2, HD] with two independent values per byte; bf16 scales
    [B, H, S] in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    HD = H * D
    if packed:
        k, v = (pack_int4(*(torch.randint(-8, 8, (B, S // 2, HD), generator=g,
                                          dtype=torch.int8)
                            for _ in range(2))) for _ in range(2))
    else:
        k, v = (torch.randint(-128, 128, (B, S, HD), generator=g,
                              dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand((B, H, S), generator=g) + 0.5).to(torch.bfloat16)
              for _ in range(2))
    return torch.randn((B, HD), generator=g).to(torch.bfloat16), k, v, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["lean8", "lean4"])
def test_lean_attention_kernel_matches_twin(cuda, packed):
    """K7 against its twin (fp32 on the CPU, the int8 dots exact): finite,
    within 2^-6 of the output's range (one p8 or bf16-probability rounding
    flip)."""
    for B, S, H, D in ((3, 256, 6, 64), (64, 256, 6, 64), (5, 16, 6, 64),
                       (4, 64, 2, 16), (4, 96, 3, 128), (2, 34, 4, 32),
                       (2, 1000, 6, 64)):
        x = _lean_inputs(packed, B, S, H, D, seed=S)
        before = lean_attention.launches
        out = lean_attention(*(t.to(cuda) for t in x), packed, n_head=H)
        assert lean_attention.launches == before + 1
        torch.cuda.synchronize()
        ref = lean_attention_reference(*x, packed, n_head=H)
        out = out.cpu()
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 2.0 ** -6 * ref.abs().max(), (
            B, S, H, D)


@pytest.mark.cuda
def test_lean_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v, ks, vs = (t.to(cuda) for t in _lean_inputs(False, 2, 16, 6, 64))
    with pytest.raises(ValueError, match="q must be"):
        lean_attention(q.float(), k, v, ks, vs, False)
    with pytest.raises(ValueError, match="k must be"):
        lean_attention(q, k.view(torch.uint8), v, ks, vs, False)
    with pytest.raises(ValueError, match="k_scale must be"):
        lean_attention(q, k, v, ks.float(), vs, False)
    with pytest.raises(ValueError, match="k must be"):  # packed: S/2 rows
        lean_attention(q, k, v, ks, vs, True)
    with pytest.raises(ValueError, match="contiguous"):
        lean_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                       ks, vs, False)
    with pytest.raises(ValueError, match="head size"):
        lean_attention(q, k, v, ks, vs, False, n_head=4)  # D = 96
    with pytest.raises(ValueError, match="even S"):
        odd = torch.ones((2, 6, 17), dtype=torch.bfloat16, device=cuda)
        lean_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous(), odd,
                       odd, True)
    S = MAX_S + 2
    big = torch.zeros((1, S // 2, 384), dtype=torch.int8, device=cuda)
    s = torch.ones((1, 6, S), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lean_attention(q[:1], big, big, s, s, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lean8", "lean4"])
def test_probe_step_launches_k7_once_per_layer(cuda, name):
    """The probe path on the card: every step launches K7 exactly L = 6
    times, and its q stays finite."""
    before = lean_attention.launches
    r = int4_kernel_probe.run_variant(name, batch=64, seq=256, device=cuda,
                                      iters=2)
    assert r["steps"] == 3
    assert lean_attention.launches - before == int4_kernel_probe.L * 3
    assert torch.isfinite(r["q"].float()).all()
    assert r["ms_per_layer"] > 0 and r["floor_ms"] > 0


@pytest.mark.cuda
def test_plain_quantizers_on_cuda_match_cpu_bit_for_bit(cuda):
    """Every division by 127 in the port's plain code is one IEEE division
    on the card too (models.gpt.true_divide; PyTorch's CUDA division by a
    Python number multiplies by its reciprocal): quantize_int8 and the
    int8_dots row quantizer give the CPU's bits, and the lean8 twin on the
    card stays within the K7 yardstick of the CPU's at a batch where q8
    values one ulp apart flipped outputs at near-ties of the top scores."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4096, 6, 64), generator=g) * (
        torch.rand((4096, 6, 1), generator=g) * 10)
    for quantize in (quantize_int8, lambda t: _quantize_rows(t, -127)):
        for got, want in zip(quantize(x.to(cuda)), quantize(x)):
            assert torch.equal(got.cpu(), want)
    x = _lean_inputs(False, 1024, 256, 6, 64, seed=1)
    got = lean_attention_reference(*(t.to(cuda) for t in x), False).cpu()
    want = lean_attention_reference(*x, False)
    assert (got - want).abs().max() <= 2.0 ** -6 * want.abs().max()


# ---------------------------------------------------------------------------
# fp32: an fp32 model decodes through fp32 instantiations of K1 and K2
# ---------------------------------------------------------------------------


def _inputs32(quant, ring, pos, B, S, seed=0, KH=KH):
    """The operands of one fp32 decode step: fp32 q and slabs, an int8
    cache with bf16 scales or an fp32 cache."""
    x = _inputs(quant, ring, pos, B, S, seed=seed, KH=KH)
    x[0], x[3], x[4] = (t.float() for t in (x[0], x[3], x[4]))
    if not quant:
        x[1], x[2] = x[1].float(), x[2].float()
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kv_heads", [KH, H], ids=["gqa", "mha"])
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_gqa_decode_fp32_kernel_matches_twin(cuda, quant, ring, kv_heads):
    """K1's fp32 instantiation (fp32 q and slabs over an fp32 or int8
    cache) against the twin in fp32 on the CPU: caches and scales
    bit-exact (the int8 quantize of an fp32 slab included), the fp32 output
    within 1e-5 of its range (summation order only); at G = 1 also B=5 (a
    partial block) and B=1 over S=1024 (the column split)."""
    for B, S in ((8, 32), (3, 77), (64, 128), (3, 1024), (5, 32), (1, 1024)):
        for pos in (0, 5, S - 1):
            cpu = _inputs32(quant, ring, pos, B, S, KH=kv_heads)
            gpu = [None if a is None else a.to(cuda) for a in cpu]
            pos_cpu = torch.tensor(pos, dtype=torch.int32)
            before = gqa_decode_update.launches
            out = gqa_decode_update(*gpu, pos_cpu.to(cuda))
            assert gqa_decode_update.launches == before + 1
            ref = gqa_decode_update(*cpu, pos_cpu)
            torch.cuda.synchronize()
            for got, want in zip(gpu[1:], cpu[1:]):
                if got is not None:
                    assert torch.equal(got.cpu(), want)
            assert out.dtype == torch.float32
            err = (out.cpu() - ref).abs().max()
            assert err <= 1e-5 * ref.abs().max(), (B, S, pos, err)


def _spec_inputs32(quant, T, cursor, B, S, H, D, seed=0):
    """The verify operands with a full fp32 q (and an fp32 cache and slab
    when not quantized, full fp32 values too: not bf16 ones, whose every
    split part past the first would be 0), a dead row added."""
    x = _spec_inputs(quant, T, cursor, B, S, H, D, seed=seed, dead_row=True)
    g = torch.Generator().manual_seed(seed + 1)
    names = ("q",) if quant else ("q", "k", "v", "k_slab", "v_slab")
    for n in names:
        x[n] = torch.randn(x[n].shape, generator=g)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("write", [False, True], ids=["k3", "k2"])
def test_spec_attention_fp32_kernel_matches_twin(cuda, write, quant):
    """The fp32 verify kernel (the tensor-core kernel of
    csrc/spec_attention_mma.cuh for an fp32 q, split passes: fp16 hi + lo
    over an int8 cache, 3xTF32 over an fp32 one) against the twin in fp32,
    at both regimes and over the long cache: the slab write bit-exact, the
    dead row 0, the rest within 1e-5 of its range."""
    for B, S, H, D in ((3, 64, 6, 64), (3, 256, 6, 64), (2, 32, 2, 16),
                       (2, 128, 2, 128), (2, 72, 4, 32), (3, 1024, 6, 64)):
        for T in (1, 5, 8, 17, 128):
            Tw = -(-T // 8) * 8
            if Tw > S:
                continue
            for cursor in sorted({0, S - Tw}) if write else (S - Tw,):
                cpu = _spec_inputs32(quant, T, cursor, B, S, H, D, seed=T)
                gpu = _on(cpu, cuda)
                fn = spec_attention_update if write else spec_attention
                before = fn.launches
                if write:
                    out = fn(*[gpu[n] for n in UPD], n_head=H)
                    write_slab(cpu["k"], cpu["v"], cpu["k_slab"],
                               cpu["v_slab"], cursor)
                else:
                    out = fn(*[gpu[n] for n in ATT], n_head=H)
                assert fn.launches == before + 1
                torch.cuda.synchronize()
                for n in ("k", "v"):
                    assert torch.equal(gpu[n].cpu(), cpu[n]), (n, B, T)
                assert out.dtype == torch.float32
                ref = spec_attention_reference(
                    *[cpu[n] for n in ATT], n_head=H)[:-1]
                out = out.cpu()
                assert torch.equal(out[-1], torch.zeros_like(out[-1]))
                err = (out[:-1] - ref).abs().max()
                assert err <= 1e-5 * ref.abs().max(), (B, S, T, cursor, err)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 128])
def test_spec_attention_fp32_kernel_at_the_sample_cli_shape(cuda, T):
    """The fp32 kernel at the shape of its only user path, cli/sample.py
    --speculative --dtype=float32 (64 rows, S = block_size 256, MHA at the
    bench widths, an int8 cache): a verify step (T=5) and a refresh
    (T=128), with the write; bit-exact write, dead row 0, the rest within
    1e-5 of its range of the fp32 twin."""
    Tw = -(-T // 8) * 8
    for cursor in (0, 256 - Tw):
        cpu = _spec_inputs32(True, T, cursor, 64, 256, H, D, seed=T + cursor)
        gpu = _on(cpu, cuda)
        before = spec_attention_update.launches
        out = spec_attention_update(*[gpu[n] for n in UPD], n_head=H)
        assert spec_attention_update.launches == before + 1
        write_slab(cpu["k"], cpu["v"], cpu["k_slab"], cpu["v_slab"], cursor)
        torch.cuda.synchronize()
        for n in ("k", "v"):
            assert torch.equal(gpu[n].cpu(), cpu[n]), (n, T, cursor)
        ref = spec_attention_reference(*[cpu[n] for n in ATT], n_head=H)[:-1]
        out = out.cpu()
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))
        err = (out[:-1] - ref).abs().max()
        assert err <= 1e-5 * ref.abs().max(), (T, cursor, err)


@pytest.mark.cuda
def test_fp32_kernels_refuse_mixed_types(cuda):
    x = _on(_spec_inputs32(False, 5, 8, 2, 32, 6, 64), cuda)
    with pytest.raises(ValueError, match="k must be"):  # a bf16 cache
        spec_attention(x["q"], x["k"].bfloat16(), x["v"], None, None,
                       x["col_pos"], x["lengths"], n_head=6)
    # int8_dots takes an fp32 q (the Pallas kernel quantizes q from fp32
    # either way): it runs and matches its twin
    cpu8 = _spec_inputs32(True, 5, 8, 2, 32, 6, 64)
    x8 = _on(cpu8, cuda)
    out = spec_attention(*[x8[n] for n in ATT], n_head=6, int8_dots=True)
    assert out.dtype == torch.float32
    ref = spec_attention_int8_dots_reference(*[cpu8[n] for n in ATT],
                                             n_head=6)[:-1]
    err = (out.cpu()[:-1] - ref).abs().max()
    assert err <= 2.0 ** -6 * ref.abs().max(), err
    args = [None if a is None else a.to(cuda)
            for a in _inputs32(False, False, 0, 4, 16)]
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k must be"):
        gqa_decode_update(args[0], args[1].bfloat16(), *args[2:], pos)
    with pytest.raises(ValueError, match="k_slab must be"):
        gqa_decode_update(args[0].half(), args[1], args[2],
                          args[3].half(), args[4].half(), *args[5:], pos)


FP32_SMALL = dict(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                  n_embd=384, bias=False, dtype=torch.float32)


def _fp32_models(cuda, **kw):
    """The same fp32 weights on the CPU and the card (``wte`` scaled by 10:
    greedy choices then are not near-ties that summation order flips)."""
    cpu = init_weights(GPT(GPTConfig(**{**FP32_SMALL, **kw}), device="cpu"),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.transformer.wte.weight.mul_(10.0)
    return cpu.eval(), copy.deepcopy(cpu).to(cuda).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(kv_quantized=True, n_kv_head=2, flat_kv=True),
    dict(kv_quantized=False, n_kv_head=None),
], ids=["int8-kh2-flat", "fp32-mha"])
def test_fp32_generator_on_cuda_matches_cpu(cuda, variant, monkeypatch):
    """A greedy fp32 Generator (window 64, 100 new tokens: two refreshes)
    on the card gives the CPU's tokens, through K1 (n_layer launches per
    step) and never the twin."""
    from ai_music_generation_tpu_torch.ops import gqa_decode as ops

    cpu, gpu = _fp32_models(cuda, **variant)
    prompts = torch.randint(0, 128, (16, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    kw = dict(max_new_tokens=100, temperature=0.0, top_k=None)
    want = Generator(cpu, **kw).generate(prompts)
    twin_calls = []
    monkeypatch.setattr(ops, "gqa_decode_reference",
                        lambda *a: twin_calls.append(1))
    before = gqa_decode_update.launches
    got = Generator(gpu, **kw).generate(prompts).cpu()
    assert gqa_decode_update.launches - before == 2 * 100
    assert not twin_calls
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_fp32_spec_generator_on_cuda_matches_cpu(cuda, quant, monkeypatch):
    """A greedy fp32 SpecGenerator (MHA) on the card gives the CPU's tokens
    and step count, through the fp32 K2 once per layer per model call and
    never the twin."""
    from ai_music_generation_tpu_torch.ops import spec_attention as ops

    cpu, gpu = _fp32_models(cuda, kv_quantized=quant)
    prompts = torch.randint(0, 128, (16, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(3))
    kw = dict(max_new_tokens=60, temperature=0.0, top_k=None)
    want, want_steps = SpecGenerator(cpu, **kw).generate_with_stats(prompts)
    monkeypatch.setattr(ops, "_twin", lambda *a: pytest.fail("twin called"))
    calls = []
    handle = gpu.register_forward_pre_hook(
        lambda _, args: calls.append(args[0].shape[1]))
    before = spec_attention_update.launches
    got, steps = SpecGenerator(gpu, **kw).generate_with_stats(prompts)
    handle.remove()
    assert spec_attention_update.launches - before == 2 * len(calls)
    assert steps == want_steps and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_ring_model_ticks_on_cuda_match_cpu(cuda, dtype):
    """Ring-mode T=1 ticks (the serving cache) of a 2-layer bench-width
    model (KH=2, int8) on the card against the CPU: rows at staggered
    lengths, the cursor wrapping a 32-column ring; logits within 2^-4 of
    their range in bf16 (8 ulps), 2^-8 in fp32 (an fp32 projection at an
    int8 rounding tie may quantize one step apart on the two sides); K1
    n_layer times a tick."""
    cfg = GPTConfig(**{**FP32_SMALL, "dtype": dtype, "kv_quantized": True,
                       "n_kv_head": 2, "flat_kv": True})
    cpu = init_weights(GPT(cfg, device="cpu"),
                       torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).to(cuda).eval()
    B, S, ticks = 8, 32, 20
    caches = [KVCache.create(cfg, B, max_len=S, device=d, per_row=True)
              for d in (cuda, "cpu")]
    for c in caches:
        c.length.copy_(torch.arange(0, 24, 3, dtype=torch.int32))
        c.cursor.fill_(25)
    ids = torch.randint(0, 128, (B, ticks), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(4))
    tol = 2.0 ** -4 if dtype == torch.bfloat16 else 2.0 ** -8
    before = gqa_decode_update.launches
    with torch.inference_mode():
        for t in range(ticks):
            got, _ = gpu(ids[:, t:t + 1].to(cuda), cache=caches[0])
            want, _ = cpu(ids[:, t:t + 1], cache=caches[1])
            want = want.float()
            err = (got.float().cpu() - want).abs().max()
            assert err <= tol * want.abs().max(), (t, err)
            for c in caches:  # keep every row below S
                c.length.remainder_(S - 1)
    assert gqa_decode_update.launches - before == cfg.n_layer * ticks
    assert int(caches[0].cursor) == int(caches[1].cursor) == (25 + ticks) % S


# -- the training path (no kernel of the port: plain torch ops, cuBLAS) ------

TRAIN_SMALL = dict(block_size=64, vocab_size=96, n_layer=2, n_head=6,
                   n_embd=384, bias=False)


def _train_pair(cuda, dtype, **kw):
    cfg = GPTConfig(**{**TRAIN_SMALL, "dtype": dtype, **kw})
    cpu = init_weights(GPT(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    return cpu, copy.deepcopy(cpu).to(cuda)


def _train_batch(accum=2, B=4, T=64, seed=5):
    g = torch.Generator().manual_seed(seed)
    x, y = (torch.randint(0, 96, (accum, B, T), generator=g,
                          dtype=torch.int32) for _ in range(2))
    y[..., -4:] = -1
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_head", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)],
                         ids=["fp32", "bf16"])
def test_train_step_on_cuda_matches_cpu(cuda, dtype, tol, n_kv_head):
    """Two steps of train/step.py (accum 2, AdamW fused on the card, the
    clip) on the card and the CPU from the same weights and batches: loss
    and grad_norm within ``tol`` of their value, parameters within ``tol``
    of their range (fp32 1e-4: cuBLAS and the CPU sum in other orders; bf16
    2^-6)."""
    models = _train_pair(cuda, dtype, n_kv_head=n_kv_head)
    steps = [make_train_step(m, make_optimizer(m, 1e-3), grad_clip=1.0)
             for m in models]
    for it in range(2):
        x, y = _train_batch(seed=it)
        want = steps[0](x, y, it)
        got = steps[1](x.to(cuda), y.to(cuda), it)
        for key in ("loss", "grad_norm"):
            w = float(want[key])
            assert abs(float(got[key]) - w) <= tol * abs(w), (it, key)
    ref = models[0].state_dict()
    span = max(float(v.abs().max()) for v in ref.values())
    for name, value in models[1].state_dict().items():
        err = float((value.cpu() - ref[name]).abs().max())
        assert err <= tol * span, (name, err / span)


@pytest.mark.cuda
def test_dropout_masks_on_cuda_equal_cpu(cuda):
    """The counter-hash masks (and the kept values, divided by 1 - p as one
    IEEE division) are bit-equal on the card and the CPU."""
    key = gpt_module.dropout_key(1337, 12, 1)
    x = torch.randn((4, 6, 64, 64), generator=torch.Generator().manual_seed(1))
    for layer in range(3):
        for site in range(4):
            got = gpt_module.dropout_keep(x.shape, 0.2, key, layer, site,
                                          cuda)
            assert torch.equal(got.cpu(), gpt_module.dropout_keep(
                x.shape, 0.2, key, layer, site))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        assert torch.equal(
            gpt_module.dropout(xd.to(cuda), 0.2, key, 1, 2).cpu(),
            gpt_module.dropout(xd, 0.2, key, 1, 2))


@pytest.mark.cuda
def test_remat_on_cuda_gives_the_same_gradients(cuda):
    """With dropout 0.2, one forward and backward with ``remat`` on the
    card gives the loss of one without, bit for bit, and its gradients
    within 1e-6 of their range (the recompute replays the same kernels)."""
    x, y = _train_batch(accum=1)
    grads = []
    for remat in (False, True):
        _, model = _train_pair(cuda, torch.bfloat16, dropout=0.2,
                               remat=remat)
        _, loss = model(x[0].to(cuda), y[0].to(cuda),
                        dropout_key=gpt_module.dropout_key(3, 0, 0))
        loss.backward()
        grads.append((loss.detach(), [p.grad.clone()
                                      for p in model.parameters()]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


# -- the dropout kernel (csrc/dropout.cu) -------------------------------------

# shape, models.gpt.dropout's mesh arguments, and the (start, full) they
# stand for: whole sites of the attention-probability and [B, T, C] kinds
# (sizes off the kernel's 8- and 4-element vectors, and one of many blocks
# a grid-stride), a data rank's rows of a site, a rank's rows and heads of
# the probabilities (head0 2 of 6)
DROP_SITES = {
    "probs": ((4, 6, 64, 64), (), None),
    "probs-odd": ((3, 5, 19, 19), (), None),
    "btc-odd": ((3, 17, 37), (), None),
    "probs-b16": ((16, 6, 256, 256), (), None),
    "rows": ((3, 5, 24), (types.SimpleNamespace(data_rank=1, n_data=3),),
             ((3, 0, 0), (9, 5, 24))),
    "heads": ((2, 2, 33, 33),
              (types.SimpleNamespace(data_rank=1, n_data=2), 2, 6),
              ((2, 2, 0, 0), (4, 6, 33, 33))),
}


def _dropout_pair(cuda, shape, dtype, p, key, mesh, block, seed=0):
    """(forward, gradient) of ``models.gpt.dropout`` on the card (the
    kernel) and of the twin on the CPU under autograd, on the same x and
    upstream gradient; the card's launches in between."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    up = torch.randn(shape, generator=g).to(dtype)
    a, b = x.to(cuda).requires_grad_(), x.clone().requires_grad_()
    before = dropout_apply.launches
    got = gpt_module.dropout(a, p, key, 3, gpt_module.SITE_ATTN_PROBS, *mesh)
    got.backward(up.to(cuda))
    torch.cuda.synchronize()
    launches = dropout_apply.launches - before
    want = dropout_reference(b, p, key, 3, gpt_module.SITE_ATTN_PROBS,
                             *(block or ()))
    want.backward(up)
    return (got.detach().cpu(), a.grad.cpu()), (want.detach(), b.grad), \
        launches


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("site", list(DROP_SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dropout_kernel_matches_twin(cuda, dtype, site, p):
    """The kernel's forward and backward (one launch each) equal the
    twin's on the CPU, differentiated by autograd, bit for bit: the mask of
    record, kept values and gradients divided by 1 - p as one IEEE
    division in x's dtype, dropped ones +0."""
    shape, mesh, block = DROP_SITES[site]
    key = gpt_module.dropout_key(1337, 12, 1)
    got, want, launches = _dropout_pair(cuda, shape, dtype, p, key, mesh,
                                        block)
    assert launches == 2
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dropout_kernel_with_tunesformer_core_keys(cuda, dtype):
    """Under each TunesFormer core's key (core_dropout_key of one step
    key) the kernel equals the twin bit for bit at every site."""
    from ai_music_generation_tpu_torch.models.tunesformer import (
        CHAR_CORE, PATCH_CORE, core_dropout_key,
    )

    step_key = gpt_module.dropout_key(49, 123)
    for core in (PATCH_CORE, CHAR_CORE):
        got, want, launches = _dropout_pair(
            cuda, (31, 4, 16, 16), dtype, 0.1,
            core_dropout_key(step_key, core), (), None, seed=core)
        assert launches == 2
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_dropout_kernel_takes_strided_and_offset_inputs(cuda):
    """A non-contiguous x (a transpose) and one that starts off a 16-byte
    boundary (a slice) give the twin's values of the same logical tensor."""
    key = gpt_module.dropout_key(5, 6, 0)
    x = torch.randn((8, 40), generator=torch.Generator().manual_seed(1))
    for view in (lambda t: t.t(), lambda t: t.reshape(-1)[3:-5]):
        got = dropout_apply(view(x.to(cuda)), 0.2, key, 1, 2)
        assert torch.equal(got.cpu(), dropout_reference(view(x), 0.2, key, 1,
                                                        2))


@pytest.mark.cuda
def test_music_train_step_with_the_kernel_equals_the_twin(cuda, monkeypatch):
    """One forward and backward of the music configuration (6 layers, 6
    heads, 384 wide, 2 kv-heads, block 256, vocab 128, dropout 0.2, bf16)
    at batch 8 on the card with the kernel (38 launches: 19 sites, forward
    and backward) and with ``models.gpt.dropout`` calling the twin
    directly: the losses bit-equal, every gradient within 1e-6 of its
    range (as the remat test: the rest of the step replays the same
    kernels)."""
    cfg = GPTConfig(n_layer=6, n_head=6, n_embd=384, n_kv_head=2,
                    block_size=256, vocab_size=128, bias=False, dropout=0.2,
                    dtype=torch.bfloat16)
    model = init_weights(GPT(cfg, device="cpu"),
                         torch.Generator().manual_seed(0)).to(cuda).train()
    g = torch.Generator().manual_seed(2)
    x, y = (torch.randint(0, 128, (8, 256), generator=g).to(cuda)
            for _ in range(2))
    key = gpt_module.dropout_key(1337, 7, 0)
    runs = []
    for twin in (False, True):
        if twin:
            monkeypatch.setattr(
                gpt_module, "dropout",
                lambda x, p, key, layer, site, *mesh: dropout_reference(
                    x, p, key, layer, site))
        model.zero_grad(set_to_none=True)
        before = dropout_apply.launches
        _, loss = model(x, y, dropout_key=key)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), [p.grad.clone()
                                     for p in model.parameters()],
                     dropout_apply.launches - before))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert (n0, n1) == (38, 0)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


# -- the TunesFormer paths: K1 at MHA H = KH = 12 over a bf16 cache ----------

def _tunes_inputs(B, S, ring, pos, seed=0):
    g = torch.Generator().manual_seed(seed)
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)  # noqa
    C = 12 * D
    mask_rel = None
    if ring:
        lengths = torch.randint(0, S, (B,), generator=g)
        lengths[0], lengths[-1] = 0, S - 1
        offset = (pos - torch.arange(S)) % S
        mask_rel = (lengths[:, None] - offset[None, :]).to(torch.int32)
    return [bf(B, 12, D), bf(B, S, C), bf(B, S, C), bf(B, C), bf(B, C),
            None, None, mask_rel]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,ring", [
    (16, 32, False), (1024, 32, False), (3, 32, False), (16, 128, False),
    (1024, 128, True), (3, 128, True), (1024, 128, False), (8, 32, False),
    (8, 128, False), (1, 32, False), (1, 128, False), (64, 32, False),
    (64, 128, True)])
def test_gqa_decode_kernel_at_the_tunesformer_shapes(cuda, B, S, ring):
    """K1 at the char core's (S=32) and the patch core's (S=128, lockstep
    and the server's ring) shapes, at the batches of the generator (16,
    1024), the server (1024 slots, 64 behind HTTP) and the CLIs (8 tunes,
    1 a leadsheet), pos at both ends: caches bit-exact, the
    output within one bf16 ulp of its range of the twin in fp32; in ring
    mode the same rows rolled to another cursor give the same bits."""
    for pos in (0, 1, 5, S - 1):
        cpu = _tunes_inputs(B, S, ring, pos)
        gpu = [None if a is None else a.to(cuda) for a in cpu]
        cpu32 = [None if a is None else
                 (a.float() if i in (0, 3, 4) else a.clone())
                 for i, a in enumerate(cpu)]
        p = torch.tensor(pos, dtype=torch.int32)
        out = gqa_decode_update(*gpu, p.to(cuda))
        gqa_decode_update(*cpu, p)
        ref32 = gqa_decode_reference(*cpu32, p)
        torch.cuda.synchronize()
        for got, want in zip(gpu[1:3], cpu[1:3]):
            assert torch.equal(got.cpu(), want)
        err = (out.float().cpu() - ref32).abs().max()
        assert err <= 2.0 ** -7 * ref32.abs().max(), (B, S, pos, err)
        if ring:
            shift = 37
            moved = [a if a is None or i in (0, 3, 4) else
                     a.roll(shift, dims=1).contiguous()
                     for i, a in enumerate(gpu)]
            again = gqa_decode_update(*moved, torch.tensor(
                (pos + shift) % S, dtype=torch.int32, device=cuda))
            assert torch.equal(again, out)


@pytest.mark.cuda
def test_gqa_decode_kernel_at_the_gpt2_shape(cuda):
    """K1 at GPT-2 124M's decode step (MHA H = KH = 12, D = 64, a bf16
    cache of n_positions = 1024 columns, lockstep), 4 rows, pos from 0 to
    S-1: caches bit-exact, the output within one bf16 ulp of its range of
    the twin in fp32."""
    S = 1024
    for pos in (0, 7, 8, 130, 511, S - 1):
        cpu = _tunes_inputs(4, S, False, pos, seed=pos)
        gpu = [None if a is None else a.to(cuda) for a in cpu]
        cpu32 = [None if a is None else
                 (a.float() if i in (0, 3, 4) else a.clone())
                 for i, a in enumerate(cpu)]
        p = torch.tensor(pos, dtype=torch.int32)
        before = gqa_decode_update.launches
        out = gqa_decode_update(*gpu, p.to(cuda))
        assert gqa_decode_update.launches == before + 1
        gqa_decode_update(*cpu, p)
        ref32 = gqa_decode_reference(*cpu32, p)
        torch.cuda.synchronize()
        for got, want in zip(gpu[1:3], cpu[1:3]):
            assert torch.equal(got.cpu(), want)
        err = (out.float().cpu() - ref32).abs().max()
        assert err <= 2.0 ** -7 * ref32.abs().max(), (pos, err)


TUNES_TINY = dict(patch_length=16, patch_size=16, patch_layers=2,
                  char_layers=2, n_embd=64, n_head=4, dropout=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -4)],
                         ids=["fp32", "bf16"])
def test_tiny_tunesformer_on_cuda_matches_cpu(cuda, dtype, tol):
    """A tiny TunesFormer on the card against the same weights on the CPU:
    a cached prefill, 3 patch steps and a 16-position char scan, hidden
    states and logits within ``tol`` of their range; K1 patch_layers times
    a patch step and char_layers times a char step."""
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )

    cfg = TunesFormerConfig(**TUNES_TINY, dtype=dtype)
    cpu = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                   torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).to(cuda).eval()
    x = torch.randint(0, 128, (3, 16, 16), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(1))
    outs, launches = [], []
    with torch.inference_mode():
        for model in (cpu, gpu):
            dev = model.device
            cache = KVCache.create(cfg.patch_core_config(), 3, max_len=16,
                                   device=dev)
            model.encode_patches_cached(x[:, :6].to(dev), cache)
            hs = []
            for i in range(6, 9):
                before = gqa_decode_update.launches
                h, _ = model.patch_step(x[:, i].to(dev), cache)
                launches.append(gqa_decode_update.launches - before)
                hs.append(h.float().cpu())
            ccache = KVCache.create(cfg.char_core_config(), 3, max_len=16,
                                    device=dev)
            enc = h
            for j in range(16):
                before = gqa_decode_update.launches
                lg, _ = model.char_step(enc, x[:, 9, j].to(dev), ccache)
                launches.append(gqa_decode_update.launches - before)
                hs.append(lg.float().cpu())
            outs.append(hs)
    for got, want in zip(outs[1], outs[0]):
        assert (got - want).abs().max() <= tol * want.abs().max()
    assert launches[:19] == [0] * 19
    assert launches[19:] == [cfg.patch_layers] * 3 + [cfg.char_layers] * 16


@pytest.mark.cuda
def test_tunes_server_on_cuda_is_slot_independent(cuda):
    """The server on the card: a request alone in slot 0 and again in slot
    1 behind a filler (the ring cursor elsewhere) gives the same text; 105
    K1 launches a bar at the reference depth's formula
    (patch_layers + patch_size * char_layers)."""
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )
    from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer

    cfg = TunesFormerConfig(**TUNES_TINY)
    model = init_tunesformer_weights(
        TunesFormer(cfg, device=cuda),
        torch.Generator(device=cuda).manual_seed(0)).eval()
    srv = TunesServer(model, n_slots=4)
    prompt = "S:1\nL:1/8\nK:C\nCDEF|"
    texts, bars = [], []
    bar = srv._bar

    def counted(packed):
        bars.append(1)
        return bar(packed)

    srv._bar = counted
    before = gqa_decode_update.launches
    for filler in (False, True):
        if filler:
            srv.submit("K:D\nde|", max_patch=12, seed=2)
        rid = srv.submit(prompt, max_patch=12, seed=7)
        texts.append({r.id: r for r in srv.run_until_idle()}[rid].text)
    assert texts[0] == texts[1] and len(texts[0]) > len(prompt)
    per_bar = cfg.patch_layers + cfg.patch_size * cfg.char_layers
    assert gqa_decode_update.launches - before == per_bar * len(bars)


def _tunes_train_pair(cuda, dtype, dropout=0.0):
    """(CPU TunesFormer, the same init weights on the card), 2+1 layers at
    64 wide over a 32 x 16 patch grid."""
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )

    cfg = TunesFormerConfig(patch_length=32, patch_size=16, patch_layers=2,
                            char_layers=1, n_embd=64, n_head=4,
                            dropout=dropout, dtype=dtype)
    cpu = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                   torch.Generator().manual_seed(0))
    return cpu, copy.deepcopy(cpu).to(cuda)


def _tunes_batch(seed, B=3, P=32, S=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(3, 128, (B, P, S), generator=g, dtype=torch.int32)
    x[:, :, 0] = 1
    for b in range(B):
        x[b, int(torch.randint(4, P, (1,), generator=g)):] = 0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,dropout",
                         [(torch.float32, 1e-4, 0.0),
                          (torch.bfloat16, 2.0 ** -6, 0.0),
                          (torch.float32, 1e-4, 0.1)],
                         ids=["fp32", "bf16", "fp32-dropout"])
def test_tunes_train_step_on_cuda_matches_cpu(cuda, dtype, tol, dropout):
    """Three steps of train/tunes_step.py (optax_adamw, the HF cosine
    schedule) on the card and the CPU from the same weights and batches:
    the losses within ``tol`` of their value, the parameters and each Adam
    moment within ``tol`` of their range, the counts equal (fp32 1e-4: cuBLAS and the CPU
    sum in other orders; bf16 2^-6); with dropout the masks are the same
    bits on both."""
    from ai_music_generation_tpu_torch.train.optimizer import (
        hf_cosine_schedule, optax_adamw,
    )
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_train_step,
    )

    models = _tunes_train_pair(cuda, dtype, dropout)
    opts = [optax_adamw(m.parameters()) for m in models]
    steps = [make_tunesformer_train_step(m, o, hf_cosine_schedule(
        1e-3, 1.0, 10)) for m, o in zip(models, opts)]
    for it in range(3):
        x = _tunes_batch(it)
        want = float(steps[0](x, it, seed=3))
        got = float(steps[1](x.to(cuda), it, seed=3))
        assert abs(got - want) <= tol * abs(want), it
    assert float(adamw_count(opts[1])) == float(adamw_count(opts[0])) == 3
    ref = models[0].state_dict()
    span = max(float(v.abs().max()) for v in ref.values())
    for name, value in models[1].state_dict().items():
        err = float((value.cpu() - ref[name]).abs().max())
        assert err <= tol * span, (name, err / span)
    for m in ("exp_avg", "exp_avg_sq"):
        want = [s[m] for s in opts[0].state.values()]
        span = max(float(v.abs().max()) for v in want)
        for i, (v, s) in enumerate(zip(want, opts[1].state.values())):
            err = float((s[m].cpu() - v).abs().max())
            assert err <= tol * span, (m, i, err / span)


@pytest.mark.cuda
def test_tunes_dropout_masks_on_cuda_equal_cpu(cuda):
    """Each core's masks (core_dropout_key of one step key) are bit-equal
    on the card and the CPU at every layer and site."""
    from ai_music_generation_tpu_torch.models.tunesformer import (
        CHAR_CORE, PATCH_CORE, core_dropout_key,
    )

    key = gpt_module.dropout_key(49, 123)
    for core in (PATCH_CORE, CHAR_CORE):
        k = core_dropout_key(key, core)
        for layer in range(3):
            for site in range(4):
                shape = (31, 4, 16, 16)
                got = gpt_module.dropout_keep(shape, 0.1, k, layer, site,
                                              cuda)
                assert torch.equal(got.cpu(), gpt_module.dropout_keep(
                    shape, 0.1, k, layer, site))


@pytest.mark.cuda
def test_tunes_nan_guard_on_cuda_keeps_every_bit(cuda):
    """On the card a NaN parameter's step leaves every parameter, moment
    and the count bit for bit as they were (the fused AdamW's found_inf,
    decided on the device)."""
    from ai_music_generation_tpu_torch.train.optimizer import (
        hf_cosine_schedule, optax_adamw,
    )
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_train_step,
    )

    _, model = _tunes_train_pair(cuda, torch.bfloat16)
    opt = optax_adamw(model.parameters())
    step = make_tunesformer_train_step(model, opt,
                                       hf_cosine_schedule(1e-3, 1.0, 10))
    step(_tunes_batch(0).to(cuda), 0)
    with torch.no_grad():
        model.char_wte.weight[5, 3] = float("nan")

    def bits(t):
        return t.detach().clone().view(torch.int32)

    params = [bits(p) for p in model.parameters()]
    state = [(bits(s["exp_avg"]), bits(s["exp_avg_sq"]), bits(s["step"]))
             for s in opt.state.values()]
    loss = step(_tunes_batch(1).to(cuda), 1)
    assert not torch.isfinite(loss)
    assert all(torch.equal(bits(p), b)
               for p, b in zip(model.parameters(), params))
    assert all(torch.equal(bits(s["exp_avg"]), m)
               and torch.equal(bits(s["exp_avg_sq"]), v)
               and torch.equal(bits(s["step"]), c)
               for (m, v, c), s in zip(state, opt.state.values()))
    assert float(adamw_count(opt)) == 1


def _synth_events(total, seed, n=48, sr=16_000):
    """Overlapping notes, a start past ``total``, a pitch halfway between
    two bank roots (24: roots 21 and 27), both velocity layers of
    ``_synth_font`` and random notes (tests/test_torch_synth.py's cases)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ev = np.stack([
        rng.integers(28, 100, n).astype(np.float32),
        rng.uniform(0, 0.8 * total, n).astype(np.float32),
        rng.uniform(0.05 * sr, 1.5 * sr, n).astype(np.float32),
        rng.uniform(0.1, 1.0, n).astype(np.float32),
    ], 1)
    ev[:6] = [[24.0, 100.5, 8000.0, 0.7], [60.0, total + 500.0, 4000.0, 0.5],
              [62.0, 1000.0, 30000.0, 0.3], [66.0, 1200.7, 20000.0, 0.9],
              [40.0, 1500.0, 12000.0, 0.45], [40.0, total - 300.0, 9000.0, 0.55]]
    return ev


def _synth_font(path):
    """Three zones, two of them velocity layers over one key range."""
    import numpy as np

    from ai_music_generation_tpu_torch.synth.sf2 import write_sf2

    def sine(freq):
        t = np.arange(4800) / 16_000
        return (0.8 * np.sin(2 * np.pi * freq * t)).astype(np.float32)

    write_sf2(str(path), [
        dict(wave=sine(220.0), root=57, key_range=(0, 63), vel_range=(0, 63),
             loop=(800, 4000), release_tc=-3600),
        dict(wave=sine(330.0), root=57, key_range=(0, 63),
             vel_range=(64, 127), release_tc=-2400),
        dict(wave=sine(880.0), root=81, key_range=(64, 127), attack_tc=-7200,
             sustain_cb=200, atten_cb=60),
    ])
    return f"sf2:{path}"


@pytest.mark.cuda
@pytest.mark.parametrize("voice", ["sample_bank", "additive", "sf2"])
def test_synth_on_cuda_matches_cpu_and_repeats(cuda, voice, tmp_path):
    """synth/render.py's batch render on the card: two runs bit-equal (each
    note's window is added in event order, no atomics), and within 1e-5 of
    the range of the CPU's render (CUDA's and the CPU's exp and sin differ
    by an ulp), with equal trim indices."""
    import numpy as np

    from ai_music_generation_tpu_torch.synth import render

    if voice == "sf2":
        voice = _synth_font(tmp_path / "font.sf2")
    total = 8 * 16_000
    batch = np.zeros((3, 48, 4), np.float32)
    for i, n in enumerate((48, 20, 35)):
        batch[i, :n] = _synth_events(total, i, n)
    first = render.render_events_batch(batch, total, voice=voice,
                                       device=cuda)
    second = render.render_events_batch(batch, total, voice=voice,
                                        device=cuda)
    assert torch.equal(first, second)
    want = render.render_events_batch(batch, total, voice=voice,
                                      device="cpu")
    span = (want.amax(1) - want.amin(1)).min()
    assert float((first.cpu() - want).abs().max() / span) <= 1e-5
    for got, ref in zip(first, want):
        assert int(render.trim_trailing_silence(got)) == \
            int(render.trim_trailing_silence(ref))


# tests/test_audiobox.py's TINY WavLM geometry
AUDIOBOX_TINY = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
    conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_distance=80)


def _aes_pair(cuda):
    from ai_music_generation_tpu_torch.eval.audiobox import (
        AesPredictor, AudioboxConfig,
    )
    from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig

    cfg = AudioboxConfig(wavlm=WavLMConfig(**AUDIOBOX_TINY))
    return [AesPredictor(cfg, batch=3, chunk_seconds=0.5, device=d)
            for d in (cuda, "cpu")]


def _hiddens(pred):
    """Record the encoder's hidden states of each forward."""
    seen = []
    pred.model.wavlm.register_forward_hook(
        lambda module, args, out: seen.append(out[1].cpu()))
    return seen


@pytest.mark.cuda
def test_tiny_predictor_on_cuda_matches_cpu_under_default_tf32(cuda):
    """The TINY Audiobox predictor on the card against the CPU with cuDNN's
    TF32 at PyTorch's default (on) and float32 matmuls set to "high" by the
    caller: the predictor pins IEEE fp32 itself, so every hidden state and
    the scores sit within 1e-4 of their range of the CPU's (noise, a
    ragged chunk, a nearly silent one)."""
    import numpy as np

    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        card, cpu = _aes_pair(cuda)
        rng = np.random.default_rng(0)
        wave = (0.3 * rng.normal(size=(3, 8000))).astype(np.float32)
        wave[1, 5000:] = 0.0
        wave[2] *= 1e-4
        n_valid = np.array([8000, 5000, 8000], np.int32)
        seen_card, seen_cpu = _hiddens(card), _hiddens(cpu)
        got, want = (p.score_block(wave, n_valid) for p in (card, cpu))
        for i, (g, w) in enumerate(zip(seen_card[0], seen_cpu[0])):
            span = float(w.max() - w.min())
            assert float((g - w).abs().max()) / span <= 1e-4, i
        span = float(want.max() - want.min())
        assert float(np.abs(got - want).max()) / span <= 1e-4
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


@pytest.mark.cuda
def test_predictor_chunk_invariance_on_cuda(cuda):
    """A file scores on the card alone as it does among others (the frame
    mask reaches the encoder and every row of the canonical batch is
    computed on its own)."""
    import numpy as np

    card, _ = _aes_pair(cuda)
    wave = (0.05 * np.random.default_rng(1).normal(size=12345)).astype(
        np.float32)
    alone = card.score_wave(wave)
    crowd = card.score_waves([(np.zeros(16000, np.float32), 16000),
                              (wave, 16000)])[1]
    for axis, value in alone.items():
        assert abs(value - crowd[axis]) <= 1e-5 * abs(value) + 1e-7, axis


MOE_SMALL = dict(n_expert=4, expert_top_k=2, capacity_factor=1.25)
# the router's weights scaled up, and prompts (seed 3) on which no routing
# decision of the CPU run lies within MOE_MARGIN (in log-probability) of a
# tie: fp32 sums on the card and the CPU in other orders (~1e-6 of a
# value), and a near-tie token may then take another expert; the CPU run
# asserts the margin
MOE_ROUTER_SCALE, MOE_MARGIN = 20.0, 1e-4


def _moe_margins(model):
    """Forward hooks on each MoE layer that record the smallest gap between
    the log-probabilities of a token's j-th and (j+1)-th expert, j <= K."""
    gaps = []
    K = model.config.expert_top_k

    def hook(moe, args, out):
        logp = torch.sort(moe.probs(args[0]).log(), -1, descending=True)[0]
        gaps.append(float((logp[:, :K] - logp[:, 1:K + 1]).min()))

    return gaps, [b.moe.register_forward_hook(hook)
                  for b in model.transformer.h]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(kv_quantized=True, n_kv_head=2, flat_kv=True),
    dict(kv_quantized=False, n_kv_head=None),
], ids=["int8-kh2-flat", "fp32-mha"])
def test_moe_generator_on_cuda_matches_cpu(cuda, variant, monkeypatch):
    """A greedy fp32 MoE Generator (4 experts, top 2; window 64, 100 new
    tokens: two refreshes) on the card gives the CPU's tokens, through K1
    (n_layer launches per step) and never the twin; the routing of the CPU
    run clears MOE_MARGIN."""
    from ai_music_generation_tpu_torch.ops import gqa_decode as ops

    cpu = init_weights(GPT(GPTConfig(**{**FP32_SMALL, **MOE_SMALL,
                                        **variant}), device="cpu"),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.transformer.wte.weight.mul_(10.0)
        for block in cpu.transformer.h:
            block.moe.router.weight.mul_(MOE_ROUTER_SCALE)
    gpu = copy.deepcopy(cpu).to(cuda).eval()
    prompts = torch.randint(0, 128, (16, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(3))
    kw = dict(max_new_tokens=100, temperature=0.0, top_k=None)
    gaps, hooks = _moe_margins(cpu)
    want = Generator(cpu.eval(), **kw).generate(prompts)
    for h in hooks:
        h.remove()
    assert min(gaps) > MOE_MARGIN
    twin_calls = []
    monkeypatch.setattr(ops, "gqa_decode_reference",
                        lambda *a: twin_calls.append(1))
    before = gqa_decode_update.launches
    got = Generator(gpu, **kw).generate(prompts).cpu()
    assert gqa_decode_update.launches - before == 2 * 100
    assert not twin_calls
    assert torch.equal(got, want)
