"""The port's speculative-verify attention (ai_music_generation_tpu_torch/ops/
spec_attention.py) against the JAX package.

The same inputs, made with numpy from a seed, go through the port's plain
twins and the JAX functions: ``spec_attention_reference`` and the off-TPU
``spec_attention_update`` (write, then the reference), and, for the
``int8_dots`` mode, the Pallas kernel in interpret mode (the JAX reference
ignores ``int8_dots`` off the TPU). Inputs follow
tests/test_spec_attention.py::make_inputs: ragged per-row histories, dead
columns (``INVALID_POS``) past them and between them, and the T fresh
columns at the cursor. Caches are bit-exact. The CUDA kernel is held
against the twins in tests/test_torch_cuda_kernels.py (no JAX there).

Tolerances: fp32 differs only by accumulation order, 1e-5 of the output's
range; bf16 rounds the scores and probabilities at other places in the two
frameworks' einsums, 2^-6 of the range (two bf16 ulps at the largest
value); the int8_dots twin mirrors the Pallas body's integer products
exactly and differs only in fp32 softmax rounding, 2^-7 of the range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import _quantize_int8_flat, _scale_write
from ai_music_generation_tpu.ops.spec_attention import (
    spec_attention as jax_spec_attention,
)
from ai_music_generation_tpu.ops.spec_attention import (
    spec_attention_reference as jax_spec_attention_reference,
)
from ai_music_generation_tpu.ops.spec_attention import (
    spec_attention_update as jax_spec_attention_update,
)
from ai_music_generation_tpu_torch.experiments import (
    int8_dots_probe, register_caps,
)
from ai_music_generation_tpu_torch.models.gpt import (
    KVCache,
    quantize_int8,
    scale_write,
)
from ai_music_generation_tpu_torch.ops import _build
from ai_music_generation_tpu_torch.ops.spec_attention import (
    _check_cuda,
    spec_attention,
    spec_attention_f32_mma_model,
    spec_attention_int8_dots_reference,
    spec_attention_mma_model,
    spec_attention_reference,
    spec_attention_update,
    split_f16,
    split_tf32,
    to_tf32,
)

torch.set_num_threads(1)

INVALID = KVCache.INVALID_POS
DTYPES = {"fp32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _bf16(a):
    """fp32 numpy values rounded to bf16 (kept as fp32: exact in both)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def make_inputs(B=4, T=5, H=2, S=64, D=64, quant=True, cursor=None, seed=0):
    """numpy operands of one verify call: row b has n_b live history
    columns outside the write window at positions 0..n_b-1 (about a tenth
    of the others killed, as rejected drafts are), the T fresh columns at
    ``cursor`` (default S - Tw) at positions n_b..n_b+T-1, and every other
    column dead. Values are bf16-representable. Returns a dict."""
    HD, Tw = H * D, -(-T // 8) * 8
    cursor = S - Tw if cursor is None else cursor
    rng = np.random.default_rng(seed)
    hist = np.concatenate([np.arange(cursor), np.arange(cursor + Tw, S)])
    nvalid = rng.integers(0, S - Tw + 1, (B,))
    rank = np.arange(len(hist))
    col_pos = np.full((B, S), INVALID, np.int64)
    col_pos[:, hist] = np.where(rank[None] < nvalid[:, None], rank[None],
                                INVALID)
    col_pos[rng.random((B, S)) < 0.1] = INVALID
    col_pos[:, cursor:cursor + T] = nvalid[:, None] + np.arange(T)
    x = {"q": _bf16(rng.standard_normal((B, T, HD))),
         "col_pos": col_pos.astype(np.int32),
         "lengths": nvalid.astype(np.int32), "cursor": cursor,
         "k_scale": None, "v_scale": None}
    if quant:
        for n in ("k", "v", "k_slab", "v_slab"):
            x[n] = rng.integers(-127, 128, (B, Tw if "slab" in n else S, HD)
                                ).astype(np.int8)
        for n in ("k_scale", "v_scale"):
            x[n] = _bf16(rng.uniform(0.002, 0.02, (B, H, S)))
    else:
        for n in ("k", "v", "k_slab", "v_slab"):
            x[n] = _bf16(rng.standard_normal((B, Tw if "slab" in n else S,
                                              HD)))
    return x


def _torch(x, dtype=torch.bfloat16):
    def t(a):
        if a is None:
            return None
        a = torch.from_numpy(np.array(a))
        return a.to(dtype) if a.dtype == torch.float32 else a

    out = {n: t(x[n]) for n in ("q", "k", "v", "k_slab", "v_slab",
                                "col_pos", "lengths")}
    for n in ("k_scale", "v_scale"):  # scales stay bf16 in every dtype
        out[n] = t(x[n]) if x[n] is None else t(x[n]).to(torch.bfloat16)
    return out


def _jax(x, dtype=jnp.bfloat16):
    def j(a):
        if a is None:
            return None
        return jnp.asarray(a, dtype) if a.dtype == np.float32 else \
            jnp.asarray(a)

    out = {n: j(x[n]) for n in ("q", "k", "v", "k_slab", "v_slab",
                                "col_pos", "lengths")}
    for n in ("k_scale", "v_scale"):
        out[n] = None if x[n] is None else jnp.asarray(x[n], jnp.bfloat16)
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.is_floating_point() else a).numpy()
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(
        a.dtype, jnp.floating) else a)


def _args(d, *names):
    return [d[n] for n in names]


ATT = ("q", "k", "v", "k_scale", "v_scale", "col_pos", "lengths")


def _assert_close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


TOL = {"fp32": 1e-5, "bf16": 2.0 ** -6}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("T", [1, 5, 8, 13])
def test_twin_matches_jax_reference(T, quant, dtype):
    _, tdt, jdt = DTYPES[dtype]
    x = make_inputs(T=T, quant=quant, seed=T)
    t, j = _torch(x, tdt), _jax(x, jdt)
    want = jax_spec_attention_reference(*_args(j, *ATT), n_head=2)
    got = spec_attention_reference(*_args(t, *ATT), n_head=2)
    assert got.dtype == tdt
    assert not torch.isnan(got.float()).any()
    _assert_close(got, want, TOL[dtype])
    # the wrapper runs the same twin on CPU tensors and launches nothing
    before = spec_attention.launches
    assert torch.equal(spec_attention(*_args(t, *ATT), n_head=2), got)
    assert spec_attention.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("T,cursor", [(1, 0), (5, 8), (8, 24), (13, 48)])
def test_update_matches_jax(T, cursor, quant, dtype):
    """The write (in place, at the cursor) is bit-exact with JAX's
    dynamic_update_slice; the attention then reads the fresh columns."""
    _, tdt, jdt = DTYPES[dtype]
    x = make_inputs(T=T, quant=quant, cursor=cursor, seed=40 + T)
    t, j = _torch(x, tdt), _jax(x, jdt)
    jk, jv, want = jax_spec_attention_update(
        *_args(j, "q", "k", "v", "k_slab", "v_slab", "k_scale", "v_scale",
               "col_pos", "lengths"), cursor, n_head=2)
    before = spec_attention_update.launches
    got = spec_attention_update(
        *_args(t, "q", "k", "v", "k_slab", "v_slab", "k_scale", "v_scale",
               "col_pos", "lengths"), torch.tensor(cursor, dtype=torch.int32),
        n_head=2)
    assert spec_attention_update.launches == before
    np.testing.assert_array_equal(_np(t["k"]), _np(jk))
    np.testing.assert_array_equal(_np(t["v"]), _np(jv))
    _assert_close(got, want, TOL[dtype])


def test_within_step_causality_and_dead_columns():
    """Query t sees fresh columns 0..t and not t+1.. (perturbing fresh
    column 2 moves queries 2.. only); poisoned dead columns change
    nothing."""
    x = make_inputs(B=2, T=4, quant=True, seed=3)
    t = _torch(x, torch.float32)
    out = spec_attention_reference(*_args(t, *ATT), n_head=2)
    col = x["cursor"] + 2
    k2, v2 = t["k"].clone(), t["v"].clone()
    k2[:, col], v2[:, col] = 127, -127
    moved = spec_attention_reference(t["q"], k2, v2, *_args(
        t, "k_scale", "v_scale", "col_pos", "lengths"), n_head=2)
    assert torch.equal(out[:, :2], moved[:, :2])
    assert not torch.equal(out[:, 2:], moved[:, 2:])
    dead = t["col_pos"] == INVALID
    k3 = torch.where(dead[:, :, None], torch.tensor(127, dtype=torch.int8),
                     t["k"])
    ks3 = torch.where(dead[:, None, :], torch.tensor(1e4).to(torch.bfloat16),
                      t["k_scale"])
    vs3 = torch.where(dead[:, None, :], torch.tensor(1e4).to(torch.bfloat16),
                      t["v_scale"])
    poisoned = spec_attention_reference(
        t["q"], k3, t["v"], ks3, vs3, t["col_pos"], t["lengths"], n_head=2)
    assert torch.equal(out, poisoned)


@pytest.mark.parametrize("q_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("T", [5, 8])
def test_int8_dots_twin_matches_pallas_interpret(T, q_dtype):
    """The int8_dots twin against the Pallas kernel in interpret mode, with
    a bf16 q and with a full fp32 one (the Pallas kernel quantizes q from
    fp32 in either dtype): out in q's dtype, within 2^-7 of its range (the
    twin differs only in fp32 softmax rounding)."""
    if q_dtype == "bf16":
        x = make_inputs(B=2, T=T, H=2, S=32, quant=True, seed=20 + T)
        t, j = _torch(x), _jax(x)
    else:
        x = make_inputs(B=2, T=T, H=2, S=32, quant=True, seed=30 + T)
        x["q"] = np.random.default_rng(40 + T).standard_normal(
            x["q"].shape).astype(np.float32)
        t, j = _torch(x, torch.float32), _jax(x, jnp.float32)
    want = jax_spec_attention(*_args(j, *ATT), n_head=2, interpret=True,
                              int8_dots=True)
    got = spec_attention_int8_dots_reference(*_args(t, *ATT), n_head=2)
    assert got.dtype == (torch.bfloat16 if q_dtype == "bf16"
                         else torch.float32)
    _assert_close(got, want, 2.0 ** -7)
    # the wrappers select the same twin on CPU tensors
    assert torch.equal(spec_attention(*_args(t, *ATT), n_head=2,
                                      int8_dots=True), got)


def test_int8_dots_needs_int8_cache():
    t = _torch(make_inputs(T=5, quant=False))
    with pytest.raises(ValueError, match="int8 cache"):
        spec_attention(*_args(t, *ATT), n_head=2, int8_dots=True)
    with pytest.raises(ValueError, match="int8 cache"):
        spec_attention_update(
            *_args(t, "q", "k", "v", "k_slab", "v_slab", "k_scale",
                   "v_scale", "col_pos", "lengths"), 0, n_head=2,
            int8_dots=True)


def test_wrappers_refuse_other_devices():
    t = {n: None if a is None else a.to("meta")
         for n, a in _torch(make_inputs(T=5)).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        spec_attention(*_args(t, *ATT), n_head=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        spec_attention_update(
            *_args(t, "q", "k", "v", "k_slab", "v_slab", "k_scale",
                   "v_scale", "col_pos", "lengths"), 0, n_head=2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,cursor", [(1, 0), (5, 16), (13, 40)])
def test_padded_slab_quantize_and_scale_window_bit_exact(T, cursor, dtype):
    """The spec branch's int8 path: the slab zero-padded to Tw, quantized
    per (column, head) (JAX ``_quantize_int8_flat``; the zero pad columns
    get scale bf16(1e-6/127)), and the scales written into the window
    [cursor, cursor+Tw) of a [B, H, S] buffer."""
    _, tdt, jdt = DTYPES[dtype]
    B, H, D, S = 3, 6, 64, 64
    Tw = -(-T // 8) * 8
    rng = np.random.default_rng(T)
    slab = np.zeros((B, Tw, H * D), np.float32)
    slab[:, :T] = rng.standard_normal((B, T, H * D)) * rng.uniform(
        1e-3, 1e2, (B, T, 1))
    slab = torch.from_numpy(slab).to(tdt)
    jq, js = _quantize_int8_flat(jnp.asarray(slab.float().numpy(), jdt), H)
    q, s = quantize_int8(slab.reshape(B, Tw, H, D))
    np.testing.assert_array_equal(q.reshape(B, Tw, H * D).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _np(js))
    pad = torch.tensor(1e-6 / 127, dtype=torch.float32).to(torch.bfloat16)
    assert (s[:, T:] == pad).all() and (q[:, T:] == 0).all()
    buf = _bf16(rng.uniform(0, 1, (B, H, S)))
    want = _scale_write(jnp.asarray(buf, jnp.bfloat16), js, cursor)
    got = scale_write(torch.from_numpy(buf).to(torch.bfloat16), s,
                      torch.tensor(cursor, dtype=torch.int32))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("softmax", ["sharp", "flat"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16cache"])
@pytest.mark.parametrize("T", [5, 128])
def test_mma_numerics_model_within_the_kernel_yardstick(T, quant, softmax):
    """The PV roundings of the tensor-core kernel (fp16 P x row factor
    over int8 V; bf16 hi + lo P over bf16 V), evaluated on the CPU, stay
    within chip_smoke's yardstick of the fp32 twin: one bf16 ulp, 2^-7, of
    the output's range. Inputs have phase 6's distributions (int8 values
    over [-127, 127] with scales 0.002-0.02, or normal bf16 caches; normal
    q), q scaled by 16 (sharp) or 1/64 (flat); a row whose every column is
    dead gives 0."""
    x = make_inputs(B=4, T=T, H=2, S=256, quant=quant, cursor=0 if T > 8
                    else None, seed=T + quant)
    x["q"] = _bf16(x["q"] * (16.0 if softmax == "sharp" else 1 / 64))
    x["col_pos"][0] = INVALID  # row 0 reads nothing
    t = _torch(x)
    args = _args(t, *ATT)
    got = spec_attention_mma_model(*args, n_head=2).float()
    args[0] = args[0].float()
    want = spec_attention_reference(*args, n_head=2)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isnan(want[0]).all()  # the twin has no dead-row rule
    err = (got[1:] - want[1:]).abs().max()
    assert err <= 2.0 ** -7 * want[1:].abs().max(), err


def _fp32_args(T, quant, softmax):
    """The operands of spec_attention in fp32, at phase 16's distributions
    with every operand a full fp32 value: q normal (x16 sharp, x1/64
    flat), an int8 cache with its scales or a normal fp32 cache; row 0
    reads nothing."""
    x = make_inputs(B=4, T=T, H=2, S=256, quant=quant, cursor=0 if T > 8
                    else None, seed=T + quant)
    rng = np.random.default_rng(100 + T + quant)
    x["q"] = (rng.standard_normal(x["q"].shape)
              * (16.0 if softmax == "sharp" else 1 / 64)).astype(np.float32)
    if not quant:
        for n in ("k", "v"):
            x[n] = rng.standard_normal(x[n].shape).astype(np.float32)
    x["col_pos"][0] = INVALID  # row 0 reads nothing
    return _args(_torch(x, torch.float32), *ATT)


def _fp32_error(got, want):
    """max |got - want| over the live rows, as a share of want's range."""
    return ((got[1:] - want[1:]).abs().max()
            / want[1:].abs().max()).item()


@pytest.mark.parametrize("softmax", ["sharp", "flat"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp32cache"])
@pytest.mark.parametrize("T", [5, 128])
def test_f32_mma_numerics_model_within_the_kernel_yardstick(T, quant,
                                                            softmax):
    """The split operands of the tensor-core kernel for an fp32 q (fp16 hi
    + lo of q and of P over an int8 cache, 3xTF32 over an fp32 one),
    evaluated on the CPU, stay within chip_smoke's fp32 yardstick of the
    fp32 twin: 1e-5 of the output's range. A row whose every column is dead
    gives 0."""
    args = _fp32_args(T, quant, softmax)
    got = spec_attention_f32_mma_model(*args, n_head=2)
    want = spec_attention_reference(*args, n_head=2)
    assert got.dtype == torch.float32
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isnan(want[0]).all()  # the twin has no dead-row rule
    assert _fp32_error(got, want) <= 1e-5


@pytest.mark.parametrize("softmax", ["sharp", "flat"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp32cache"])
def test_f32_yardstick_fails_a_single_rounding_pass(quant, softmax):
    """The 1e-5 yardstick has teeth: q rounded once to bf16 (the bf16
    kernel's single pass over an int8 cache), or q, K and V rounded once to
    tf32 (a single TF32 pass over an fp32 cache), lands outside it."""
    args = _fp32_args(128, quant, softmax)
    want = spec_attention_reference(*args, n_head=2)
    single = list(args)
    if quant:
        single[0] = args[0].bfloat16().float()
    else:
        single[:3] = (to_tf32(a) for a in args[:3])
    assert _fp32_error(spec_attention_reference(*single, n_head=2),
                       want) > 1e-5


def _across_exponents(rng, shape, lo, hi):
    """fp32 values of random sign and full 24-bit significands whose
    exponents are uniform over [lo, hi)."""
    m = rng.integers(1 << 23, 1 << 24, shape) / float(1 << 23)
    x = np.ldexp(m, rng.integers(lo, hi, shape)) * rng.choice([-1, 1], shape)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("operand", ["q", "p"])
def test_fp16_split_is_within_2_22(operand):
    """The kernel's two-pass fp16 operand over an int8 cache: each row
    (a (head, query) row of q, or of P x v_scale) scaled by the power of two
    that lifts its largest |x| into [2^14, 2^15), then split into fp16 hi +
    lo. Rows whose largest values sit anywhere in 2^-40..2^10 (q) or
    2^-12..2^-5 (P x v_scale, non-negative), each holding values down to
    2^-30 of its largest: hi and lo are fp16 values and hi + lo is within
    2^-22 of each scaled value, or 2^-25 (2^-39 of the row's largest) where
    lo falls among fp16's subnormals."""
    rng = np.random.default_rng(7 if operand == "q" else 8)
    rows, width = 256, 64
    base = rng.integers(-40, 10, (rows, 1)) if operand == "q" else \
        rng.integers(-12, -5, (rows, 1))
    x = _across_exponents(rng, (rows, width), -30, 1) * torch.from_numpy(
        np.ldexp(1.0, base).astype(np.float32))
    if operand == "p":
        x = x.abs()
    _, ex = torch.frexp(x.abs().amax(dim=-1, keepdim=True))
    y = x * torch.ldexp(torch.ones_like(x[:, :1]), 15 - ex)  # exact
    assert (y.abs().amax(dim=-1) >= 2 ** 14).all()
    assert (y.abs() < 2 ** 15).all()
    hi, lo = split_f16(y)
    for part in (hi, lo):
        assert torch.equal(part.half().float(), part)
    err = (hi.double() + lo.double() - y.double()).abs()
    bound = torch.maximum(y.double().abs() * 2.0 ** -22,
                          torch.full_like(err, 2.0 ** -25))
    assert (err <= bound).all()
    # most values sit where the relative bound holds, and a bf16 or fp16
    # single pass would miss it there
    rel = y.abs() >= 2 ** -3
    assert rel.float().mean() > 0.5
    assert ((y.half().float() - y).abs() > 2.0 ** -22 * y.abs())[rel].any()


def test_tf32_split_is_within_2_22():
    """The 3xTF32 operand over an fp32 cache: fp32 values across exponents
    2^-60..2^60 split into tf32 hi + lo (13 low bits clear, rounded to
    nearest with ties away from zero, as cvt.rna.tf32.f32); hi + lo within
    2^-22 of each value; and a product taken as the three passes lo.hi +
    hi.lo + hi.hi within 2^-21 of the exact product."""
    rng = np.random.default_rng(9)
    a, b = (_across_exponents(rng, (4096,), -60, 60) for _ in range(2))
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    for part in (ah, al, bh, bl):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((ah.double() + al.double() - a.double()).abs()
            <= 2.0 ** -22 * a.double().abs()).all()
    exact = a.double() * b.double()
    three = (al.double() * bh.double() + ah.double() * bl.double()
             + ah.double() * bh.double())
    assert ((three - exact).abs() <= 2.0 ** -21 * exact.abs()).all()
    # one pass would not do: hi.hi alone misses the bound
    assert ((ah.double() * bh.double() - exact).abs()
            > 2.0 ** -21 * exact.abs()).any()
    # ties round away from zero, others to nearest
    ulp = 2.0 ** -10
    got = to_tf32(torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                                1 + 3 * ulp / 4]))
    assert got.tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp]


def test_register_caps_finds_the_fp32_verify_cap():
    """experiments/register_caps.py varies one cap of the kernel source:
    the fp32 verify blocks' over an int8 cache in mma_min_blocks, which it
    finds exactly once."""
    header = (_build.CSRC / "spec_attention_mma.cuh").read_text()
    caps = register_caps.CAP.findall(header)
    assert len(caps) == 1 and caps[0][1] == "6"


@pytest.mark.parametrize("variant", sorted(int8_dots_probe.VARIANTS))
def test_int8_dots_probe_finds_its_edits(variant):
    """experiments/int8_dots_probe.py changes one part of the int8_dots mode
    a variant: each text it replaces is in the kernel source exactly once,
    and the edit changes the source (but the unchanged variant's)."""
    header = (_build.CSRC / int8_dots_probe.HEADER).read_text()
    _, edits = int8_dots_probe.VARIANTS[variant]
    edited = int8_dots_probe.variant_header(header, edits)
    assert (edited == header) == (variant == "source")


def _check_args(T=5, S=64, H=2, D=64, quant=True, write=True):
    """CPU operands of one verify call, zeros, for the wrapper's checks,
    as a dict of spec_attention_update's arguments."""
    bf, Tw, HD = torch.bfloat16, -(-T // 8) * 8, H * D
    cache = torch.int8 if quant else bf
    scale = (lambda: torch.zeros((2, H, S), dtype=bf)) if quant else None
    return dict(
        q=torch.zeros((2, T, HD), dtype=bf),
        k=torch.zeros((2, S, HD), dtype=cache),
        v=torch.zeros((2, S, HD), dtype=cache),
        k_slab=torch.zeros((2, Tw, HD), dtype=cache) if write else None,
        v_slab=torch.zeros((2, Tw, HD), dtype=cache) if write else None,
        k_scale=scale and scale(), v_scale=scale and scale(),
        col_pos=torch.zeros((2, S), dtype=torch.int32),
        lengths=torch.zeros((2,), dtype=torch.int32),
        cursor=torch.zeros((), dtype=torch.int32) if write else None)


@pytest.mark.parametrize("write", [True, False], ids=["k2", "k3"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16cache"])
def test_kernel_checks_pass_what_it_takes(quant, write):
    """The wrapper's checks (run before any launch, here on CPU tensors)
    pass the operands of both regimes, verify and refresh, and return the
    launch's shape; the regime and the shared memory are the launcher's
    (csrc/spec_attention.cu), so a long cache passes here."""
    for T, S in ((5, 256), (16, 256), (17, 256), (128, 256), (128, 1024)):
        x = _check_args(T, S, quant=quant, write=write)
        got = _check_cuda(*x.values(), 2, False)
        assert got == (2, T, S, 64, quant)


@pytest.mark.parametrize("T", [5, 8, 128])
def test_kernel_checks_take_int8_dots_with_an_fp32_q(T):
    """int8_dots takes an fp32 q as it takes a bf16 one (the kernel's fp32
    entry point instantiates the mode): the checks pass an fp32 q over the
    int8 cache, with and without the write, and still refuse a bf16 cache."""
    for write in (True, False):
        x = _check_args(T, 256, quant=True, write=write)
        x["q"] = x["q"].float()
        assert _check_cuda(*x.values(), 2, True) == (2, T, 256, 64, True)
    x = _check_args(T, 256, quant=False)
    x["q"] = x["q"].float()
    with pytest.raises(ValueError, match="int8_dots needs"):
        _check_cuda(*x.values(), 2, True)


@pytest.mark.parametrize("edit,match", [
    (dict(D=24), "head size"),     # not a multiple of 16
    (dict(D=96), "head size"),     # not a divisor of 128
    (dict(n_head=5), "multiple of n_head"),
    (dict(quant=False, int8_dots=True), "int8_dots needs"),
    (dict(T=13, S=8), "write width"),
    (dict(slab_dtype=True), "k_slab must be"),
    (dict(misaligned=True), "16-byte"),
    (dict(int_cursor=True), "cursor must be a tensor"),
], ids=["D24", "D96", "n_head5", "dots-bf16", "Tw>S", "slab-dtype",
        "misaligned", "int-cursor"])
def test_kernel_limits_are_checked_before_launch(edit, match):
    """What the kernel cannot take raises before any launch: a head size
    that is not a multiple of 16 dividing 128, HD not a multiple of n_head,
    int8_dots over a bf16 cache, a write wider than the cache, a slab not
    in the cache's dtype, a cache off a 16-byte boundary, a cursor that is
    not a device scalar."""
    edit = dict(edit)
    n_head, dots = edit.pop("n_head", 2), edit.pop("int8_dots", False)
    flags = {n: edit.pop(n, False)
             for n in ("slab_dtype", "misaligned", "int_cursor")}
    x = _check_args(**edit)
    if flags["slab_dtype"]:
        x["k_slab"] = x["k_slab"].to(torch.bfloat16)
    if flags["misaligned"]:
        v = x["v"]
        x["v"] = torch.empty(v.numel() + 1, dtype=v.dtype)[1:].view(v.shape)
    if flags["int_cursor"]:
        x["cursor"] = 0
    with pytest.raises(ValueError, match=match):
        _check_cuda(*x.values(), n_head, dots)
