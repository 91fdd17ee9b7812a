"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.decode.speculative import (
    SpecGenerator,
    keep_committed,
    reset_spec_cache,
)
from ai_music_generation_tpu_torch.experiments import int4_kernel_probe
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
    to eight (S=1024, the default block_size): caches and scales
    bit-exact, the output within one bf16 ulp of its range of the twin in
    fp32."""
    for B, S in ((8, 32), (3, 77), (64, 128), (3, 256), (3, 1024)):
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
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_dots"])
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
    probability to neighbouring integers)."""
    quant, dots = mode != "bf16", mode == "int8_dots"
    for B, S, H, D in ((3, 64, 6, 64), (3, 256, 6, 64), (8, 256, 6, 64),
                       (2, 32, 2, 16), (2, 128, 2, 128), (2, 72, 4, 32),
                       (3, 1024, 6, 64)):
        for T in (1, 5, 7, 8, 13, 16, 17, 64, 65, 128):
            Tw = -(-T // 8) * 8
            if Tw > S:
                continue
            cursors = sorted({c for c in (0, 8, S - Tw) if c <= S - Tw})
            for cursor in cursors if write else (S - Tw,):
                cpu = _spec_inputs(quant, T, cursor, B, S, H, D, seed=T,
                                   dead_row=True)
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
                assert err <= tol, (B, S, T, cursor, err, tol)


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
