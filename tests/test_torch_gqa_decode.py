"""The port's decode-step op (ai_music_generation_tpu_torch/ops/gqa_decode.py)
against the JAX package.

The same inputs, made with numpy from a seed, go through the port's plain
twin and the JAX ``gqa_decode_reference`` (what the JAX op runs off-TPU),
on the tests/test_gqa_flat.py grid: B=8, S=32, H=6, KH=2, D=64, int8 or
bf16 cache x lockstep or ring mask x pos in {0, 5, 8, S-1}, and on the same
grid at G = 1 (H = KH = 12, the TunesFormer char step's heads). The JAX side
takes its queries folded with its own ``_placement``; the port takes them
unfolded. Cache and scale writes must be bit-exact. The CUDA kernel is held
against the twin in tests/test_torch_cuda_kernels.py (no JAX there: the
machine with the card has none).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import _quantize_int8, _scale_write
from ai_music_generation_tpu.ops.gqa_decode import _placement
from ai_music_generation_tpu.ops.gqa_decode import (
    gqa_decode_reference as jax_gqa_decode_reference,
)
from ai_music_generation_tpu_torch.models.gpt import quantize_int8, scale_write
from ai_music_generation_tpu_torch.ops.gqa_decode import (
    _check_cuda,
    gqa_decode_reference,
    gqa_decode_update,
)

torch.set_num_threads(1)

B, S, H, KH, D = 8, 32, 6, 2, 64
KHD = KH * D
POSITIONS = (0, 5, 8, S - 1)


def _bf16(a):
    """fp32 numpy values rounded to bf16 (kept as fp32: exact in both)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(quant, ring, pos, b=B, s=S, seed=0, h=H, kh=KH):
    rng = np.random.default_rng(seed)
    khd = kh * D
    x = {
        "q": _bf16(rng.standard_normal((b, h, D))),
        "k_slab": _bf16(rng.standard_normal((b, khd))),
        "v_slab": _bf16(rng.standard_normal((b, khd))),
        "k_scale": None, "v_scale": None, "mask_rel": None,
    }
    if quant:
        x["k"] = rng.integers(-127, 128, (b, s, khd)).astype(np.int8)
        x["v"] = rng.integers(-127, 128, (b, s, khd)).astype(np.int8)
        x["k_scale"] = _bf16(rng.uniform(0.01, 0.11, (b, kh, s)))
        x["v_scale"] = _bf16(rng.uniform(0.01, 0.11, (b, kh, s)))
    else:
        x["k"] = _bf16(rng.standard_normal((b, s, khd)))
        x["v"] = _bf16(rng.standard_normal((b, s, khd)))
    if ring:
        lengths = rng.integers(0, s, (b,))
        offset = (pos - np.arange(s)) % s
        x["mask_rel"] = (lengths[:, None] - offset[None, :]).astype(np.int32)
    return x


def _torch_args(x, device="cpu"):
    def t(a):
        if a is None:
            return None
        a = torch.from_numpy(np.array(a))
        return (a.to(torch.bfloat16) if a.dtype == torch.float32 else a).to(
            device)

    return [t(x[n]) for n in ("q", "k", "v", "k_slab", "v_slab", "k_scale",
                              "v_scale", "mask_rel")]


def _jax_run(x, pos, h=H, kh=KH):
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa
    P = _placement(h, kh, D, jnp.bfloat16)
    q_bd = jnp.einsum("bhd,hdc->bhc", bf(x["q"]), P)
    cache = (jnp.asarray(x["k"]) if x["k"].dtype == np.int8 else bf(x["k"]),
             jnp.asarray(x["v"]) if x["v"].dtype == np.int8 else bf(x["v"]))
    res = jax_gqa_decode_reference(
        q_bd, *cache, bf(x["k_slab"])[:, None], bf(x["v_slab"])[:, None],
        bf(x["k_scale"]), bf(x["v_scale"]),
        None if x["mask_rel"] is None else jnp.asarray(x["mask_rel"]), pos,
        n_head=h, n_kv_head=kh)
    out = jnp.einsum("bhc,hdc->bhd", res[-1].astype(jnp.float32),
                     P.astype(jnp.float32))
    return [np.asarray(r.astype(jnp.float32) if r.dtype == jnp.bfloat16
                       else r) for r in res[:-1]], np.asarray(out)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


# (quant, ring, pos, H, KH): the GQA grid (G = 3), then the same at G = 1
# with the TunesFormer char step's 12 heads (S = 32)
TWIN_CASES = [
    pytest.param(quant, ring, pos, h, kh, id=f"{prefix}{qn}-{rn}-{pos}")
    for prefix, h, kh in (("", H, KH), ("mha-", 12, 12))
    for quant, qn in ((False, "bf16"), (True, "int8"))
    for ring, rn in ((False, "lockstep"), (True, "ring"))
    for pos in POSITIONS]


@pytest.mark.parametrize("quant,ring,pos,h,kh", TWIN_CASES)
def test_twin_matches_jax_reference(quant, ring, pos, h, kh):
    x = _inputs(quant, ring, pos, h=h, kh=kh)
    (jk, jv, *jscales), jout = _jax_run(x, pos, h=h, kh=kh)
    q, k, v, ks, vs, k_scale, v_scale, mask = _torch_args(x)
    out = gqa_decode_reference(q, k, v, ks, vs, k_scale, v_scale, mask,
                               torch.tensor(pos, dtype=torch.int32))
    # the cache writes (and int8 quantize + scale writes) are bit-exact
    np.testing.assert_array_equal(_np(k), jk)
    np.testing.assert_array_equal(_np(v), jv)
    if quant:
        np.testing.assert_array_equal(_np(k_scale), jscales[0])
        np.testing.assert_array_equal(_np(v_scale), jscales[1])
    # out: the same op chain in bf16 on both sides; the bf16 einsums may
    # accumulate in another order (XLA vs torch CPU kernels), which can move
    # a rounded bf16 score or probability by one ulp (2^-8 relative), so
    # allow 1% of the output's range
    err = np.abs(_np(out) - jout).max()
    assert err <= 1e-2 * np.abs(jout).max(), err


def test_quantize_int8_bit_exact():
    rng = np.random.default_rng(1)
    rows = [
        rng.standard_normal((6, 64)) * rng.uniform(1e-3, 1e3, (6, 1)),
        # exact .5 ties at scale 1 (max 127): round half to even
        np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 8]),
        np.zeros((1, 64)),  # all-zero row: the 1e-6 scale floor
        # saturation: the max element lands on +-127 exactly
        np.array([[-1e30, 1e29, 3.0, -7.0] * 16]),
        np.full((1, 64), 1e-40),  # subnormal input
    ]
    x = np.concatenate(rows).astype(np.float32).reshape(-1, 2, 32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        jq, js = _quantize_int8(jnp.asarray(xt.float().numpy()).astype(jdtype))
        q, s = quantize_int8(xt)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(
            s.float().numpy(), np.asarray(js.astype(jnp.float32)))
    assert q.abs().max() == 127


@pytest.mark.parametrize("start", [0, 3, 29])
def test_scale_write_matches_jax(start):
    rng = np.random.default_rng(start)
    buf = _bf16(rng.uniform(0, 1, (B, KH, S)))
    new = _bf16(rng.uniform(0, 1, (B, 3, KH)))
    ref = _scale_write(jnp.asarray(buf, jnp.bfloat16),
                       jnp.asarray(new, jnp.bfloat16), start)
    got = scale_write(torch.from_numpy(buf).to(torch.bfloat16),
                      torch.from_numpy(new).to(torch.bfloat16),
                      torch.tensor(start, dtype=torch.int32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_wrapper_runs_twin_for_cpu_tensors():
    x = _inputs(True, False, 5)
    a, b = _torch_args(x), _torch_args(x)
    pos = torch.tensor(5, dtype=torch.int32)
    before = gqa_decode_update.launches
    out = gqa_decode_update(*a, pos)
    ref = gqa_decode_reference(*b, pos)
    assert gqa_decode_update.launches == before  # no kernel on the CPU
    for got, want in zip([out, *a], [ref, *b]):
        if got is not None:
            assert torch.equal(got, want)


def test_wrapper_refuses_other_devices():
    x = _torch_args(_inputs(False, False, 0), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gqa_decode_update(*x, torch.zeros((), dtype=torch.int32,
                                          device="meta"))


def _check_args(S=128, D=64, KH=2, H=6, quant=False, ring=False):
    """CPU operands of one decode step, zeros, for the wrapper's checks."""
    bf = torch.bfloat16
    cache = torch.int8 if quant else bf
    scale = (torch.zeros((2, KH, S), dtype=bf) if quant else None)
    return [torch.zeros((2, H, D), dtype=bf),
            torch.zeros((2, S, KH * D), dtype=cache),
            torch.zeros((2, S, KH * D), dtype=cache),
            torch.zeros((2, KH * D), dtype=bf),
            torch.zeros((2, KH * D), dtype=bf), scale,
            None if scale is None else scale.clone(),
            torch.zeros((2, S), dtype=torch.int32) if ring else None,
            torch.zeros((), dtype=torch.int32)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
def test_kernel_checks_pass_what_it_takes(quant, ring):
    """The wrapper's checks (run before any launch, here on CPU tensors)
    pass the operands of every mode and return the launch's shape; the
    kernel's shared memory is its own launcher's to check, so a long S
    passes here."""
    for S in (128, 1024, 4096):
        got = _check_cuda(*_check_args(S, quant=quant, ring=ring))
        assert got == (2, S, 6, 2, 64, quant)


@pytest.mark.parametrize("edit,match", [
    (dict(D=24), "head size"),   # not a multiple of 16
    (dict(D=96), "head size"),   # not a divisor of 128
    (dict(KH=4), "multiple of n_kv_head"),
    (dict(k_scale_only=True), "both be given"),
    (dict(dtype=True), "q must be"),
    (dict(misaligned=True), "16-byte"),
], ids=["D24", "D96", "KH4", "one-scale", "q-fp32", "misaligned"])
def test_kernel_limits_are_checked_before_launch(edit, match):
    """What the kernel cannot take raises before any launch: a head size
    that is not a multiple of 16 dividing 128, n_head not a multiple of
    n_kv_head, one scale without the other, a q that is not bf16, a cache
    off a 16-byte boundary."""
    edit = dict(edit)
    flags = {n: edit.pop(n, False)
             for n in ("k_scale_only", "dtype", "misaligned")}
    args = _check_args(**edit)
    if flags["k_scale_only"]:
        args[6] = torch.zeros((2, 2, 128), dtype=torch.bfloat16)
    if flags["dtype"]:
        args[0] = args[0].float()
    if flags["misaligned"]:
        k = args[1]
        args[1] = torch.empty(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    with pytest.raises(ValueError, match=match):
        _check_cuda(*args)


def _rolled(args, shift):
    """The same ring rows with every column moved ``shift`` places on (the
    cache, scales and mask rolled along S): what a row holds when the shared
    cursor stands ``shift`` columns further."""
    out = list(args)
    for i in (1, 2):
        out[i] = args[i].roll(shift, dims=1).contiguous()
    for i in (5, 6):
        if args[i] is not None:
            out[i] = args[i].roll(shift, dims=2).contiguous()
    out[7] = args[7].roll(shift, dims=1).contiguous()
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ring_output_does_not_depend_on_the_cursor(quant):
    """Ring mode sums each row's window oldest first, so rows whose content
    sits at another cursor (everything rolled along the ring) give the same
    output bit for bit, and rows that started at column 0 give the lockstep
    output bit for bit."""
    x = _inputs(quant, True, 5, seed=3)
    base = _torch_args(x)
    want = gqa_decode_reference(*[None if a is None else a.clone()
                                  for a in base],
                                torch.tensor(5, dtype=torch.int32))
    for shift in (1, 9, S - 6):
        moved = _rolled(base, shift)
        got = gqa_decode_reference(*moved, torch.tensor(
            (5 + shift) % S, dtype=torch.int32))
        assert torch.equal(got, want), shift
    # rows at length pos from column 0: the lockstep window
    lock = _torch_args(_inputs(quant, False, 5, seed=4))
    ring = [None if a is None else a.clone() for a in lock]
    ring[7] = torch.full((B, S), 5, dtype=torch.int32) - (
        5 - torch.arange(S, dtype=torch.int32)) % S
    pos = torch.tensor(5, dtype=torch.int32)
    assert torch.equal(gqa_decode_reference(*ring, pos),
                       gqa_decode_reference(*lock, pos))


def _kernel_order(q, k, v, k_scale, v_scale, mask_rel, pos, split):
    """The output of csrc/gqa_decode_mha.cuh (K1 at G = 1) summed in its
    order, in plain torch fp32, from caches that already hold the fresh
    column: each (row, head)'s logical columns (ring mode: its window, oldest
    first, then the rest) in tiles of 32; warp w of ``split`` takes tiles
    w, w + split, ...; per tile the online softmax (the running max m, a
    sum per lane, the accumulator rescaled by exp(m_old - m)); tiles with no
    live column skipped; then the warps merged in order."""
    B, H, Dh = q.shape
    S = k.shape[1]
    kf, vf = (t.view(B, S, H, Dh).float() for t in (k, v))
    scale = 1.0 / math.sqrt(Dh)
    out = torch.zeros(B, H, Dh)
    inf = float("inf")
    for b in range(B):
        if mask_rel is None:
            order = torch.arange(pos + 1)
            live = torch.ones(pos + 1, dtype=torch.bool)
        else:
            n_win = min(max(int(mask_rel[b, pos]) + 1, 1), S)
            order = (pos + 1 - n_win + torch.arange(S)) % S
            live = mask_rel[b, order] >= 0
        n_t = -(-len(order) // 32)
        for h in range(H):
            parts = []
            for w in range(split):
                m, lanes, acc = -inf, torch.zeros(32), torch.zeros(Dh)
                for t in range(w, n_t, split):
                    cols = order[32 * t:32 * t + 32]
                    lv = live[32 * t:32 * t + 32]
                    if not lv.any():
                        continue
                    s = kf[b, cols, h] @ q[b, h].float()
                    if k_scale is not None:
                        s = s * k_scale[b, h, cols].float()
                    s = torch.where(lv, s * scale, -inf)
                    m_new = max(m, s.max().item())
                    corr = math.exp(m - m_new)
                    e = torch.exp(s - m_new)
                    lanes[:len(e)] = lanes[:len(e)] * corr + e
                    lanes[len(e):] *= corr
                    pv = e if v_scale is None else e * v_scale[b, h,
                                                                cols].float()
                    acc = acc * corr + pv @ vf[b, cols, h]
                    m = m_new
                parts.append((m, lanes.sum(), acc))
            mx = max(p[0] for p in parts)
            f = [0.0 if p[0] == -inf else math.exp(p[0] - mx) for p in parts]
            total = sum(fi * p[1] for fi, p in zip(f, parts))
            y = sum(fi * p[2] for fi, p in zip(f, parts))
            out[b, h] = y / total if total > 0 else y * 0
    return out


# small cases of K1's G = 1 steps, each with the column split its launcher
# picks at the full shape: (B, S, H, ring, int8 cache, split)
ORDER_CASES = {
    "char": (4, 32, 12, False, False, 1),      # TunesFormer B=1024: one tile
    "moe": (2, 256, 6, False, False, 4),       # B=256, S=256: 1536 rows
    "gpt2": (1, 1024, 12, False, False, 4),    # B=256, S=1024: 3072 rows
    "ring": (4, 128, 12, True, False, 1),      # the tunes server's patch step
    "ring-split": (3, 128, 6, True, True, 2),
    "int8": (3, 128, 6, False, True, 2),
}


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_mha_reduction_order_matches_the_twin(name):
    """K1's G = 1 kernel sums in another order than the twin (online over
    32-column tiles, split over warps, merged): that order, followed in
    torch fp32, lands within 1e-5 of the output's range of the twin in
    fp32 (q and slabs upcast), at every position kind."""
    b, s, h, ring, quant, split = ORDER_CASES[name]
    for pos in sorted({0, 5, min(33, s - 1), s - 1}):
        x = _torch_args(_inputs(quant, ring, pos, b=b, s=s, seed=pos, h=h,
                                kh=h))
        x = [None if a is None else
             (a.float() if i in (0, 3, 4) else a) for i, a in enumerate(x)]
        p = torch.tensor(pos, dtype=torch.int32)
        ref = gqa_decode_reference(*x, p)  # writes the fresh column
        got = _kernel_order(x[0], x[1], x[2], x[5], x[6], x[7], pos, split)
        err = (got - ref).abs().max()
        assert err <= 1e-5 * ref.abs().max(), (pos, err)
