"""Drive the PyTorch port's batched ABC decode paths once on an NVIDIA GPU:
the plain decode path, speculative decoding, the attn_impl="pallas" decode
path, and the lean int8 / int4 decode-attention probe path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing a result):

1. environment: the card (name and power limit from nvidia-smi), torch,
   CUDA, nvcc, ninja, triton; TF32 off for every fp32 product;
2. build: the CUDA kernels, compiled from ``ai_music_generation_tpu_torch/
   ops/csrc`` (nvcc's register/shared-memory report is printed);
3. kernel vs plain twin at the batched decode shape (B=4096, S=128, H=6,
   KH=2, D=64) and at MHA (KH=6) in all four modes (int8/bf16 cache x
   lockstep/ring mask), pos in {0, 7, 8, 127}, plus a 3-row batch, and
   3 rows over a 1024-column cache (GPTConfig's default block_size) at MHA
   with a bf16 cache and at KH=2 with an int8 one: caches and scales
   bit-exact, the output within one bf16 ulp of its range of the twin
   evaluated in fp32; then both timed on the card;
4. model: the bench-config GPT (6 layers, 6 heads, 384 wide, block 256,
   vocab 128, KH=2, int8 cache) on the card against the same weights on the
   CPU: prefill plus 16 decode steps, logits compared for 8 rows;
5. main path: ``Generator(window=128, max_new_tokens=500, temperature=0.8,
   top_k=200)`` at batch 4096 with 8-token prompts: shape, prompts kept,
   token range, same-seed determinism, and exactly n_layer * 500 kernel
   launches per generate; then decode throughput timed with CUDA events;
6. spec kernel vs twin: the verify-attention kernel with its slab write
   (K2, ``spec_attention_update``) and without (K3, ``spec_attention``) at
   B=4096 and B=3, S=256, H=6, D=64, T in {1, 5, 7, 128} (at B=3 also the
   regime edges 8, 16, 17, 64, 65, and an added fourth row that reads
   nothing: output 0), and at B=3 (+ the dead row) over S=1024, where a
   refresh runs 16-query tiles, T in {5, 17, 64, 65, 128}; cursor in
   {0, 8, S-Tw}, int8 and bf16 caches and int8_dots:
   the write bit-exact, the output within one bf16 ulp of its range of the
   twin evaluated in fp32 (2^-6 with int8_dots); then both timed at T=5 (a
   verify step) and T=128
   (a refresh), K3 also with a bf16 cache beside the one PyTorch call that
   computes it (``scaled_dot_product_attention`` under the col_pos mask);
7. spec model: the ``SPEC`` GPT (the bench config with MHA, which the spec
   cache needs) on the card against the CPU: a prefill, 4 verify steps
   with scripted rejections, a refresh; logits compared for 8 rows;
8. spec main path: ``SpecGenerator(max_new_tokens=500, temperature=0.8,
   top_k=200, n_draft=4)`` at batch 4096 with 8-token prompts, twice with
   one seed: shape, prompts kept, token range, identical runs, the n_steps
   bounds, and exactly n_layer kernel launches per model call (prefill,
   verify steps, refreshes, counted by a hook on the model); then a run
   with ragged 8-64-token prompts and a greedy run;
9. throughput: spec tokens/s and committed tokens per step beside the plain
   ``Generator`` on the same ``SPEC`` model (window 256, K1 at MHA), timed
   with CUDA events. Printed, not gated;
10. prefix kernel vs twin: the valid-prefix decode attention (K4,
    ``decode_attention``) at B=4096 and B=3, S=256, H=6, D=64, bf16,
    lengths {1, 63, 64, 100, 255, 256}, NaN past the length: finite and
    within one bf16 ulp of its range of the twin evaluated in fp32; then
    kernel, twin and ``scaled_dot_product_attention`` on the prefix timed
    at lengths 128 and 256;
11. pallas model: the ``PALLAS`` GPT (the bench widths with MHA, a bf16
    cache, ``attn_impl="pallas"``) on the card against the CPU: prefill plus
    16 decode steps, logits compared for 8 rows;
12. pallas main path: ``Generator(max_new_tokens=500, temperature=0.8,
    top_k=200)`` at its default window 256, batch 4096, 8-token prompts,
    twice with one seed: shape, prompts kept, token range, identical runs,
    exactly n_layer * 500 = 3000 K4 launches and no K1 launch per generate;
    then tokens/s and peak memory beside the same weights with
    ``attn_impl="xla"`` (K1). Printed, not gated;
13. int8 prefix kernels vs twin: K5 (``decode_attention_int8``) and K6
    (``decode_attention_int8_multirow``, R in {1, 8}) at B=4096 and B=16,
    S=256, lengths {1, 127, 128, 200, 256}, int8 127 and scales 1e4 past
    the length: the yardstick of phase 10; then timed at length 256;
14. lean kernel vs twin: the lean T=1 attention (K7, ``lean_attention``)
    in both modes (lean8: int8 cache, requantized q and probabilities;
    lean4: position-packed int4 cache) at B=4096 and B=3, S=256 and S=16:
    finite and within 2^-6 of its range of the twin (one p8 or
    bf16-probability rounding flip); then kernel and twin timed at B=4096,
    S=256;
15. probe path: ``experiments/int4_kernel_probe.py::run_variant`` at full
    width (B=4096, S=256, 6 layers) for xla8, lean8 and lean4: exactly 6
    K7 launches per lean step (none for xla8), a finite final q; one lean8
    and one lean4 step on a 3-row slice of the same caches against the
    twin, layer by layer, within the phase-14 yardstick; ms per layer-read
    beside each variant's byte floor, printed, not gated.

The last two lines are a JSON summary of each kernel and
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` counts its
launches in its path's main-path run (phases 5, 8, 12, 15; every count is
set to 0 just before each of them and read just after); a kernel with no
caller on any path (K3, K5, K6) shows its count summed over those four
runs there, and its kernel-vs-twin launches as ``check_launches``.
``bound_ms`` is the least time the card could take for the timed call: its
bytes (each input read once, each output written once) over 3.35 TB/s or
its operations over 989 TFLOP/s (1979 TOP/s for int8 x int8 products), the
larger; ``library_ms`` the time of one PyTorch call computing the same
function, where there is one (else null).
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import torch

BENCH = dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384,
             dropout=0.0, bias=False, dtype=torch.bfloat16, kv_quantized=True,
             n_kv_head=2, flat_kv=True)
BATCH, PROMPT_LEN, MAX_NEW, WINDOW = 4096, 8, 500, 128
# GPTConfig's default block_size: the long cache of the kernel checks
LONG = 1024
KERNEL_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/gqa_decode.cu"
KERNEL_REPLACES = "ai_music_generation_tpu/ops/gqa_decode.py:394"
# speculative decoding: the bench config with MHA (the spec cache refuses
# GQA), at the protocol of docs/experiments/spec_decode.py and cli/sample.py
SPEC = dict(BENCH, n_kv_head=None)
N_DRAFT = 4
SPEC_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/spec_attention.cu"
SPEC_REPLACES = {"spec_attention_update":
                 "ai_music_generation_tpu/ops/spec_attention.py:450",
                 "spec_attention":
                 "ai_music_generation_tpu/ops/spec_attention.py:284"}
# the attn_impl="pallas" decode path: the bench widths with MHA and a bf16
# cache off the flat branch, so each T=1 step runs K4 (JAX gpt.py:724-734);
# Generator at its default window (block_size 256)
PALLAS = dict(BENCH, n_kv_head=None, kv_quantized=False, flat_kv=False,
              attn_impl="pallas")
PREFIX_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/decode_attention.cu"
PREFIX_REPLACES = {
    "decode_attention": "ai_music_generation_tpu/ops/decode_attention.py:163",
    "decode_attention_int8":
        "ai_music_generation_tpu/ops/decode_attention_int8.py:177",
    "decode_attention_int8_multirow":
        "ai_music_generation_tpu/ops/decode_attention_int8.py:339"}
# the lean T=1 attention of the int4 probe (K7) and the probe's path
LEAN_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/lean_attention.cu"
LEAN_REPLACES = "docs/experiments/int4_kernel_probe.py:216"
LEAN_MODES = ("lean8", "lean4")
# published H100 SXM peaks (NVIDIA's data sheet, at 700 W): device
# memory rate, the dense bf16 tensor-core rate, the peak for products
# whose widest input is bf16 (int8 caches meet bf16 queries here), and the
# dense int8 rate, for int8 x int8 products
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def bound(n_bytes, n_ops, ops_per_s=BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take for work that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``n_ops`` operations at ``ops_per_s``, and which of the two sets it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def _cmd(args) -> str:
    proc = subprocess.run(args, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{args[0]} failed: {proc.stderr}")
    return proc.stdout.strip()


def phase_environment() -> str:
    from torch.utils import cpp_extension

    from ai_music_generation_tpu_torch.ops import _build

    card = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
          f"{torch.cuda.device_count()} visible")
    print(_cmd([_build._nvcc(), "--version"]).splitlines()[-1])
    print(f"ninja available: {cpp_extension.is_ninja_available()}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from ai_music_generation_tpu_torch.ops import _build

    path = _build.library_path()
    t0 = time.perf_counter()
    _build.build(path)
    print(f"built {path.name} from {[p.name for p in _build.sources()]} "
          f"in {time.perf_counter() - t0:.1f} s")
    print(path.with_suffix(".log").read_text().strip())
    _build.load_library()


def _decode_inputs(quant, ring, pos, B, S, H=6, KH=2, D=64, seed=0):
    """CPU tensors for one decode step (arguments of gqa_decode_update)."""
    g = torch.Generator().manual_seed(seed)
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)  # noqa
    q, k_slab, v_slab = bf(B, H, D), bf(B, KH * D), bf(B, KH * D)
    if quant:
        k, v = (torch.randint(-127, 128, (B, S, KH * D), generator=g,
                              dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((B, KH, S), generator=g) * 0.1
                             + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, KH * D), bf(B, S, KH * D)
        k_scale = v_scale = None
    mask_rel = None
    if ring:
        lengths = torch.randint(0, S, (B,), generator=g)
        offset = (pos - torch.arange(S)) % S
        mask_rel = (lengths[:, None] - offset[None, :]).to(torch.int32)
    return [q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel]


def _to(args, device):
    return [None if a is None else a.to(device) for a in args]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _upcast(args):
    """The same inputs with q and the fresh K/V slabs upcast (exactly) to
    fp32, and fresh copies of the caches: the twin then evaluates the
    kernel's math in fp32."""
    return [None if a is None else
            (a.float() if i in (0, 3, 4) else a.clone())
            for i, a in enumerate(args)]


def phase_kernel_vs_twin(device, B=BATCH, S=WINDOW) -> float:
    """Caches and scales must equal the twin's bit for bit. The output is
    held against the twin evaluated in fp32 (the kernel's own precision)
    within one bf16 ulp of its largest value, 2^-7 of the range: the kernel
    rounds once, to bf16, and fp32 summation order moves nothing near that.
    Its distance from the bf16 twin (which rounds scores and probabilities
    to bf16, as the JAX reference does) is printed too. Returns the largest
    error against the fp32 twin."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    worst32 = worst16 = 0.0
    cases = [(b, S, kh, quant, ring, pos) for b in (B, 3) for kh in (2, 6)
             for quant in (True, False) for ring in (False, True)
             for pos in (0, 7, 8, S - 1)]
    # a long cache (8 staged tiles of columns): MHA bf16 and GQA int8
    cases += [(3, LONG, kh, quant, ring, pos)
              for kh, quant in ((6, False), (2, True))
              for ring in (False, True) for pos in (0, 7, 8, LONG - 1)]
    for b, s_len, kh, quant, ring, pos in cases:
        cpu = _decode_inputs(quant, ring, pos, b, s_len, KH=kh)
        cpu32, dev = _upcast(cpu), _to(cpu, device)
        out = gqa_decode_update(*dev, torch.tensor(
            pos, dtype=torch.int32, device=device))
        pos_cpu = torch.tensor(pos, dtype=torch.int32)
        ref = gqa_decode_update(*cpu, pos_cpu)
        ref32 = gqa_decode_reference(*cpu32, pos_cpu)
        _sync(device)
        for name, got, want in zip(
                ("k", "v", "k_slab", "v_slab", "k_scale",
                 "v_scale"), dev[1:7], cpu[1:7]):
            if got is not None and not torch.equal(got.cpu(),
                                                   want):
                raise AssertionError(
                    f"{name} differs: B={b} S={s_len} KH={kh} quant="
                    f"{quant} ring={ring} pos={pos}")
        out = out.float().cpu()
        err = (out - ref32).abs().max().item()
        tol = 2.0 ** -7 * ref32.abs().max().item()
        if not err <= tol:
            raise AssertionError(
                f"out differs from the fp32 twin by {err} > "
                f"{tol}: B={b} S={s_len} KH={kh} quant={quant} "
                f"ring={ring} pos={pos}")
        worst32 = max(worst32, err)
        worst16 = max(worst16,
                      (out - ref.float()).abs().max().item())
    print(f"kernel vs twin: 4 modes x pos (0, 7, 8, {S - 1}) x G (3, 1) at "
          f"B={B} and B=3, S={S}, and B=3, S={LONG} (MHA bf16, G=3 int8; "
          f"pos 0, 7, 8, {LONG - 1}): caches and scales bit-exact; out max "
          f"abs err {worst32} vs the fp32 twin, {worst16} vs the bf16 twin")
    return worst32


def _cuda_ms(fn, iters) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_timing(B=BATCH, S=WINDOW) -> dict:
    """ms per call of the kernel and of the plain twin on the card, at the
    decode shape, int8 lockstep at pos = S-1 (the whole window valid). The
    K+V caches (128 MiB at B=4096) exceed the 50 MB L2, so every call reads
    them from device memory, as the decode loop does. Returns the kernel's
    JSON numbers, with its bound; no one PyTorch call fuses the quantize,
    the writes and the attention, so there is no library time."""
    from ai_music_generation_tpu_torch.ops.gqa_decode import (
        gqa_decode_reference, gqa_decode_update,
    )

    args = _to(_decode_inputs(True, False, S - 1, B, S), "cuda")
    pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    kernel, plain = [], []
    for order in (0, 1, 1, 0):  # plain, kernel, kernel, plain
        if order:
            kernel.append(_cuda_ms(lambda: gqa_decode_update(*args, pos), 50))
        else:
            plain.append(_cuda_ms(
                lambda: gqa_decode_reference(*args, pos), 20))
    ms, plain_ms = min(kernel), min(plain)
    cache_bytes = 2 * args[1].numel() + 2 * 2 * args[5].numel()
    q, k, _, k_slab, _, k_scale = args[:6]
    KHD, KH = k.shape[2], k_scale.shape[1]
    # reads: q, the S-1 older columns of K, V and their scales, the slabs;
    # writes: the fresh column of K, V and their scales, out
    n_bytes = (2 * q.nbytes + 2 * B * (S - 1) * KHD + 2 * 2 * B * KH * S
               + 2 * k_slab.nbytes + 2 * B * KHD)
    bound_ms, bound_by = bound(n_bytes, 4 * q.numel() * S)
    print(f"gqa_decode at B={B} S={S} int8: kernel {kernel} ms/call, twin "
          f"{plain} ms/call (plain, kernel, kernel, plain); best kernel "
          f"{ms:.4f} ms = {cache_bytes / ms / 1e6:.1f} GB/s of cache read, "
          f"twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes / 1e6:.1f} MB), {bound_ms / ms:.3f} of it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _bench_model(device, config=BENCH):
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    model = GPT(GPTConfig(**config), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval(), copy.deepcopy(model).to(device).eval()


@torch.inference_mode()
def phase_model(device, B=BATCH, rows=8, steps=16, config=BENCH,
                window=WINDOW) -> None:
    """Teacher-forced prefill + decode steps of the ``config`` model (cache
    of ``window`` columns, default block_size) on the card and on the CPU
    with the same weights; bf16 logits agree within 2^-4 of their range (8
    bf16 ulps at the largest logit: cuBLAS and the kernel round at other
    places than the CPU's matmuls and the twin, over 6 layers)."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    cpu_model, model = _bench_model(device, config)
    cfg = model.config
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN + steps),
                        generator=g, dtype=torch.int32)
    caches = (KVCache.create(cfg, B, window, device=device),
              KVCache.create(cfg, rows, window, device="cpu"))
    worst, tol = 0.0, 0.0
    for lo, hi in [(0, PROMPT_LEN)] + [
            (t, t + 1) for t in range(PROMPT_LEN, PROMPT_LEN + steps)]:
        got, _ = model(ids[:, lo:hi].to(device), cache=caches[0])
        want, _ = cpu_model(ids[:rows, lo:hi], cache=caches[1])
        got = got[:rows].float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        err = (got - want.float()).abs().max().item()
        tol = max(tol, 2.0 ** -4 * want.float().abs().max().item())
        if not err <= tol:
            raise AssertionError(f"logits differ by {err} > {tol} at {lo}")
        worst = max(worst, err)
    print(f"model (attn_impl={cfg.attn_impl}, n_kv_head={cfg.n_kv_head}, "
          f"kv_quantized={cfg.kv_quantized}, flat_kv={cfg.flat_kv}): prefill "
          f"{PROMPT_LEN} + {steps} decode steps at B={B}, {rows} rows vs "
          f"CPU: logits max abs err {worst} (tol {tol})")


@torch.inference_mode()
def phase_main_path(device, B=BATCH, max_new=MAX_NEW):
    """Two same-seed generates at the bench protocol, checked; returns
    (generator, prompts, kernel launches per generate)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    _, model = _bench_model(device)
    cfg = model.config
    gen = Generator(model, max_new_tokens=max_new, temperature=0.8,
                    top_k=200, window=WINDOW)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    runs = []
    for _ in range(2):
        gqa_decode_update.launches = 0
        out = gen.generate(prompts, seed=1234)
        _sync(device)
        runs.append((out.cpu(), gqa_decode_update.launches))
    (out, launches), (again, launches2) = runs
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("token out of range")
    if not torch.equal(out, again):
        raise AssertionError("same seed gave different tokens")
    # every decode step of every layer launches the kernel once (a CPU
    # rehearsal runs the twin and launches nothing)
    want = cfg.n_layer * max_new if torch.device(device).type == "cuda" else 0
    if not launches == launches2 == want:
        raise AssertionError(
            f"kernel launches per generate {launches}, {launches2} != {want}")
    print(f"main path: generate [{B}, {PROMPT_LEN}] -> {tuple(out.shape)}, "
          f"prompts kept, tokens in range, same seed identical, "
          f"{launches} kernel launches per generate")
    return gen, prompts, launches


@torch.inference_mode()
def phase_throughput(gen, prompts, runs=3) -> float:
    """Decode tokens/s over ``runs`` generates after the warm-up, timed with
    CUDA events (each run: prefill, 500 steps, refresh re-prefills)."""
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gen.generate(prompts, seed=1235 + i)
        end.record()
        torch.cuda.synchronize()
        seconds.append(start.elapsed_time(end) / 1e3)
    tok_s = prompts.shape[0] * gen.max_new_tokens / (sum(seconds) / runs)
    print(f"main path: {runs} timed generates {seconds} s, {tok_s:.1f} "
          f"tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return tok_s


def _spec_inputs(quant, T, cursor, B, S, H=6, D=64, seed=0, device="cpu",
                 n_live=None):
    """Operands of one verify call, made on ``device`` from a seed (the
    generator of tests/test_torch_spec_attention.py::make_inputs): row b
    has n_b live history columns outside the write window at positions
    0..n_b-1 (a tenth of them killed, as rejected drafts are), the T fresh
    columns at ``cursor`` at positions n_b.., every other column dead.
    ``n_live`` fixes n_b for every row and kills none."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    g = torch.Generator(device=device).manual_seed(seed)
    HD, Tw = H * D, -(-T // 8) * 8
    kw = dict(generator=g, device=device)
    hist = torch.cat([torch.arange(cursor, device=device),
                      torch.arange(cursor + Tw, S, device=device)])
    nvalid = (torch.randint(0, S - Tw + 1, (B,), **kw) if n_live is None
              else torch.full((B,), n_live, device=device))
    rank = torch.arange(len(hist), device=device)
    dead = KVCache.INVALID_POS
    col_pos = torch.full((B, S), dead, dtype=torch.int64, device=device)
    col_pos[:, hist] = torch.where(rank[None] < nvalid[:, None], rank[None],
                                   dead)
    if n_live is None:
        col_pos[torch.rand((B, S), **kw) < 0.1] = dead
    col_pos[:, cursor:cursor + T] = nvalid[:, None] + torch.arange(
        T, device=device)
    bf = lambda *shape: torch.randn(shape, **kw).to(torch.bfloat16)  # noqa
    if quant:
        k, v, k_slab, v_slab = (torch.randint(
            -127, 128, (B, n, HD), dtype=torch.int8, **kw)
            for n in (S, S, Tw, Tw))
        k_scale, v_scale = ((torch.rand((B, H, S), **kw) * 0.02
                             + 0.002).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, HD), bf(B, S, HD)
        k_slab, v_slab = bf(B, Tw, HD), bf(B, Tw, HD)
        k_scale = v_scale = None
    return dict(q=bf(B, T, HD), k=k, v=v, k_slab=k_slab, v_slab=v_slab,
                k_scale=k_scale, v_scale=v_scale,
                col_pos=col_pos.to(torch.int32),
                lengths=nvalid.to(torch.int32),
                cursor=torch.tensor(cursor, dtype=torch.int32, device=device))


SPEC_ATT = ("q", "k", "v", "k_scale", "v_scale", "col_pos", "lengths")
SPEC_UPD = ("q", "k", "v", "k_slab", "v_slab", "k_scale", "v_scale",
            "col_pos", "lengths", "cursor")


def phase_spec_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64):
    """K2 and K3 against the twins at the verify, prefill and refresh
    widths. K2's write must equal the twin's bit for bit; the output is
    held against the twin evaluated in fp32 on the card (q upcast exactly;
    TF32 off) within one bf16 ulp of its range, 2^-7 (2^-6 in int8_dots
    mode, where a probability may quantize to a neighbouring integer).
    Returns the largest error of each kernel."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_int8_dots_reference,
        spec_attention_reference, spec_attention_update, write_slab,
    )

    worst = {"spec_attention_update": 0.0, "spec_attention": 0.0}
    cases = 0
    # at B=3 also the edges of the kernel's regimes (verify T <= 16,
    # refresh tiles of 64 queries), with an added row that reads nothing;
    # over the long cache a refresh takes 16-query tiles
    for b, s_len, Ts in ((B, S, (1, 5, 7, 128)),
                         (3, S, (1, 5, 7, 8, 16, 17, 64, 65, 128)),
                         (3, LONG, (5, 17, 64, 65, 128))):
        edges = b == 3
        for T in Ts:
            Tw = -(-T // 8) * 8
            for mode in ("int8", "bf16", "int8_dots"):
                quant, dots = mode != "bf16", mode == "int8_dots"
                twin = (spec_attention_int8_dots_reference if dots
                        else spec_attention_reference)
                for write, cursors in ((True, (0, 8, s_len - Tw)),
                                       (False, (s_len - Tw,))):
                    for cursor in cursors:
                        x = _spec_inputs(quant, T, cursor, b + edges, s_len,
                                         H, D, seed=T + cursor, device=device)
                        if edges:  # the added row
                            x["col_pos"][-1] = KVCache.INVALID_POS
                        ref_k, ref_v = x["k"].clone(), x["v"].clone()
                        if write:
                            out = spec_attention_update(
                                *[x[n] for n in SPEC_UPD], n_head=H,
                                int8_dots=dots)
                            write_slab(ref_k, ref_v, x["k_slab"],
                                       x["v_slab"], x["cursor"])
                        else:
                            out = spec_attention(*[x[n] for n in SPEC_ATT],
                                                 n_head=H, int8_dots=dots)
                        _sync(device)
                        if not (torch.equal(x["k"], ref_k)
                                and torch.equal(x["v"], ref_v)):
                            raise AssertionError(
                                f"cache write differs: B={b} S={s_len} T={T}"
                                f" cursor={cursor} {mode}")
                        ref = twin(x["q"].float(), ref_k, ref_v,
                                   *[x[n] for n in SPEC_ATT[3:]], n_head=H)
                        if edges:  # the dead row: 0 here, NaN in the twin
                            if not torch.equal(out[-1],
                                               torch.zeros_like(out[-1])):
                                raise AssertionError(
                                    f"dead row not 0: S={s_len} T={T} "
                                    f"{mode}")
                            out, ref = out[:-1], ref[:-1]
                        err = (out.float() - ref).abs().max().item()
                        tol = 2.0 ** (-6 if dots else -7) * \
                            ref.abs().max().item()
                        name = ("spec_attention_update" if write
                                else "spec_attention")
                        if not err <= tol:
                            raise AssertionError(
                                f"{name} differs from the fp32 twin by "
                                f"{err} > {tol}: B={b} S={s_len} T={T} "
                                f"cursor={cursor} {mode}")
                        worst[name] = max(worst[name], err)
                        cases += 1
                        del x, ref_k, ref_v, out, ref
    print(f"spec kernel vs twin: {cases} cases (K2 and K3; int8, bf16, "
          f"int8_dots; cursors 0, 8, S-Tw) at B={B} (T 1, 5, 7, 128) and "
          f"B=3 + a dead row (T 1, 5, 7, 8, 16, 17, 64, 65, 128), S={S}, and"
          f" B=3 + a dead row over S={LONG} (T 5, 17, 64, 65, 128): writes "
          f"bit-exact; out max abs err vs the fp32 twin {worst}")
    return worst


def _spec_work(x, T, n_live, H, write):
    """(bytes, operations) of one verify call whose every query reads the
    ``n_live`` history columns and the fresh columns up to its own: reads
    q, col_pos, lengths, the live K/V columns (the fresh ones from the slab
    with the write, else from the cache) and their scales; writes out and,
    with the write, the slab into the cache."""
    B, S, HD = x["k"].shape
    D, Tw, item = HD // H, -(-T // 8) * 8, x["k"].element_size()
    fresh = Tw if write else T
    n = (2 * x["q"].nbytes + x["col_pos"].nbytes + x["lengths"].nbytes
         + 2 * B * (n_live + fresh) * HD * item
         + (2 * B * Tw * HD * item if write else 0))
    if x["k_scale"] is not None:
        n += 2 * 2 * B * H * (n_live + T)
    return n, 4 * B * H * D * (T * n_live + T * (T + 1) // 2)


def phase_spec_kernel_timing(S=256, H=6, D=64, B=BATCH):
    """ms per call of K2 and its plain twin (write_slab + the bf16
    reference, what the op runs on the CPU) at B=4096 with an int8 cache:
    a verify step (T=5, cursor S-8, every history column live: the most a
    step reads) and a refresh (T=128 at cursor 0 over an empty history),
    in the order plain, kernel, kernel, plain; K3 at the verify step, with
    the int8 cache and with a bf16 one, where one PyTorch call computes the
    same function: ``scaled_dot_product_attention`` under the boolean mask
    built from col_pos beforehand (timed library, kernel, kernel, library).
    Returns {name: the kernel's JSON numbers}: K2 and K3 (bf16) at the
    verify step, K2 at the refresh."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_reference, spec_attention_update,
        write_slab,
    )

    def plain_update(x):
        write_slab(x["k"], x["v"], x["k_slab"], x["v_slab"], x["cursor"])
        return spec_attention_reference(*[x[n] for n in SPEC_ATT], n_head=H)

    def numbers(kernel, plain, work, library=None):
        bound_ms, bound_by = bound(*work)
        return dict(ms=min(kernel), plain_ms=min(plain), bound_ms=bound_ms,
                    bound_by=bound_by,
                    library_ms=None if library is None else min(library))

    res = {}
    for label, T, cursor, n_live in (("verify", 5, S - 8, S - 8),
                                     ("refresh", 128, 0, 0)):
        x = _spec_inputs(True, T, cursor, B, S, H, D, seed=1, device="cuda",
                         n_live=n_live)
        kernel, plain = [], []
        for order in (0, 1, 1, 0):
            if order:
                kernel.append(_cuda_ms(lambda: spec_attention_update(
                    *[x[n] for n in SPEC_UPD], n_head=H), 20))
            else:
                plain.append(_cuda_ms(lambda: plain_update(x), 5))
        name = "spec_attention_update" if label == "verify" else label
        res[name] = r = numbers(kernel, plain,
                                _spec_work(x, T, n_live, H, True))
        read = (2 * B * (n_live + T) * H * D  # live K and V columns
                + 2 * 2 * B * H * S)  # the bf16 scale rows
        print(f"spec_attention_update {label} (B={B} S={S} T={T} int8, "
              f"{n_live} live history columns): kernel {kernel} ms/call, "
              f"twin {plain} ms/call (plain, kernel, kernel, plain); best "
              f"kernel {r['ms']:.4f} ms = {read / r['ms'] / 1e6:.1f} GB/s "
              f"of cache read, twin {r['plain_ms']:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of it")
        if label == "verify":
            for quant in (True, False):
                lib_call = None
                if not quant:
                    x = _spec_inputs(False, T, cursor, B, S, H, D, seed=1,
                                     device="cuda", n_live=n_live)
                    qv, kv, vv = (x[n].view(B, -1, H, D).transpose(1, 2)
                                  for n in ("q", "k", "v"))
                    mask = (x["col_pos"][:, None, None, :] <= (
                        x["lengths"][:, None] + torch.arange(
                            T, device="cuda"))[:, None, :, None])
                    lib_call = lambda: F.scaled_dot_product_attention(  # noqa
                        qv, kv, vv, attn_mask=mask)
                k3, p3, lib = [], [], []
                for order in ("plain", "library", "kernel", "kernel",
                              "library", "plain"):
                    if order == "plain":
                        p3.append(_cuda_ms(lambda: spec_attention_reference(
                            *[x[n] for n in SPEC_ATT], n_head=H), 5))
                    elif order == "kernel":
                        k3.append(_cuda_ms(lambda: spec_attention(
                            *[x[n] for n in SPEC_ATT], n_head=H), 20))
                    elif lib_call is not None:
                        lib.append(_cuda_ms(lib_call, 20))
                r = numbers(k3, p3, _spec_work(x, T, n_live, H, False),
                            lib or None)
                if not quant:
                    res["spec_attention"] = r
                print(f"spec_attention verify {'int8' if quant else 'bf16'}"
                      f": kernel {k3} ms/call, twin {p3} ms/call"
                      + (f", scaled_dot_product_attention {lib} ms/call"
                         if lib else "")
                      + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}),"
                      f" {r['bound_ms'] / r['ms']:.3f} of it")
        del x
    return res


@torch.inference_mode()
def phase_spec_model(device, B=BATCH, rows=8, verify_steps=4):
    """The spec-mode SPEC model on the card and the same weights on the CPU:
    a 7-token prefill, ``verify_steps`` T=5 steps each followed by scripted
    rejections (the SpecGenerator's bookkeeping with random commit counts),
    then a refresh (reset, 128-token re-prefill). bf16 logits within 2^-4
    of their range (the yardstick of phase 4)."""
    from ai_music_generation_tpu_torch.decode.speculative import (
        keep_committed, reset_spec_cache,
    )
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    cpu_model, model = _bench_model(device, SPEC)
    cfg = model.config
    g = torch.Generator().manual_seed(3)
    caches = (KVCache.create(cfg, B, device=device, spec=True),
              KVCache.create(cfg, rows, device="cpu", spec=True))
    T = N_DRAFT + 1
    worst, tol = 0.0, 0.0
    for n in [PROMPT_LEN - 1] + [T] * verify_steps + ["refresh", 128]:
        if n == "refresh":
            for c in caches:
                reset_spec_cache(c)
            continue
        ids = torch.randint(0, cfg.vocab_size, (B, n), generator=g,
                            dtype=torch.int32)
        before = [(c.cursor.clone(), c.length.clone()) for c in caches]
        got, _ = model(ids.to(device), cache=caches[0],
                       return_all_logits=True)
        want, _ = cpu_model(ids[:rows], cache=caches[1],
                            return_all_logits=True)
        got = got[:rows].float().cpu()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite logits on the card")
        err = (got - want.float()).abs().max().item()
        tol = max(tol, 2.0 ** -4 * want.float().abs().max().item())
        if not err <= tol:
            raise AssertionError(f"spec logits differ by {err} > {tol} "
                                 f"(call of T={n})")
        worst = max(worst, err)
        if n == T:
            commits = torch.randint(1, T + 1, (B,), generator=g,
                                    dtype=torch.int32)
            for c, (cursor0, length0), cm in zip(
                    caches, before, (commits.to(device), commits[:rows])):
                keep_committed(c, cursor0, length0, cm, T)
    if not torch.equal(caches[0].col_pos[:rows].cpu(), caches[1].col_pos):
        raise AssertionError("col_pos differs between the card and the CPU")
    print(f"spec model: prefill {PROMPT_LEN - 1} + {verify_steps} verify "
          f"steps (T={T}, scripted rejections) + refresh (T=128) at B={B}, "
          f"{rows} rows vs CPU: logits max abs err {worst} (tol {tol})")


def _spec_run(gen, prompts, prompt_lens=None, seed=1234):
    """One generate_with_stats with the model calls recorded by a hook
    (independently of the kernel's counter) and the kernel's launches;
    returns (tokens on the CPU, n_steps, the T of each call, launches)."""
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention_update,
    )

    calls = []
    handle = gen.model.register_forward_pre_hook(
        lambda _, args: calls.append(args[0].shape[1]))
    try:
        spec_attention_update.launches = 0
        out, n_steps = gen.generate_with_stats(prompts, prompt_lens,
                                               seed=seed)
        _sync(out.device)
        launches = spec_attention_update.launches
    finally:
        handle.remove()
    return out.cpu(), n_steps, calls, launches


def _check_spec_run(gen, out, n_steps, calls, launches, device, prefill):
    """The launch and step accounting of one spec generate: every model
    call (the prefill of ``prefill - 1`` tokens, the verify steps, the
    refreshes) launches the kernel once per layer, and
    ceil(committed/(K+1)) <= n_steps <= committed."""
    K, C = gen.n_draft, gen.window
    refreshes = calls.count(C)
    if calls[0] != prefill - 1 or calls.count(K + 1) != n_steps or \
            len(calls) != 1 + n_steps + refreshes:
        raise AssertionError(f"model calls {calls[:3]}..., {len(calls)} in "
                             f"all, for {n_steps} steps")
    cuda = torch.device(device).type == "cuda"
    want = gen.model.config.n_layer * len(calls) if cuda else 0
    if launches != want:
        raise AssertionError(f"spec kernel launches {launches} != {want} "
                             f"= n_layer x {len(calls)} model calls")
    committed = out.shape[1] - prefill
    if not -(-committed // (K + 1)) <= n_steps <= committed:
        raise AssertionError(f"n_steps {n_steps} outside its bounds for "
                             f"{committed} committed tokens")
    return refreshes, committed / n_steps


@torch.inference_mode()
def phase_spec_main_path(device, B=BATCH, max_new=MAX_NEW):
    """The speculative path at the protocol, through SpecGenerator: two
    same-seed runs, a ragged-prompt run and a greedy run, all checked.
    Returns (generator, prompts, launches of the first run, its n_steps,
    committed tokens per step)."""
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    _, model = _bench_model(device, SPEC)
    V = model.config.vocab_size
    gen = SpecGenerator(model, max_new_tokens=max_new, temperature=0.8,
                        top_k=200, n_draft=N_DRAFT)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, V, (B, PROMPT_LEN), generator=g,
                            dtype=torch.int32)
    out, n_steps, calls, launches = _spec_run(gen, prompts)
    again = _spec_run(gen, prompts)
    refreshes, per_step = _check_spec_run(gen, out, n_steps, calls,
                                          launches, device, PROMPT_LEN)
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < V)).all():
        raise AssertionError("token out of range")
    if not (torch.equal(out, again[0]) and again[1:] == (n_steps, calls,
                                                           launches)):
        raise AssertionError("same seed gave different runs")
    print(f"spec main path: generate [{B}, {PROMPT_LEN}] -> "
          f"{tuple(out.shape)}, prompts kept, tokens in range, same seed "
          f"identical; {n_steps} verify steps + {refreshes} refreshes + 1 "
          f"prefill, {launches} kernel launches = n_layer x model calls; "
          f"{per_step:.3f} committed tokens per step")

    # ragged prompts of 8-64 tokens: in-prompt drafts are force-accepted
    plens = torch.randint(8, 65, (B,), generator=g, dtype=torch.int32)
    ragged = torch.randint(0, V, (B, 64), generator=g, dtype=torch.int32)
    r_out, r_steps, r_calls, r_launches = _spec_run(gen, ragged, plens)
    bucket = 1 << (min(int(plens.min()), gen.window).bit_length() - 1)
    _, r_per_step = _check_spec_run(gen, r_out, r_steps, r_calls, r_launches,
                                    device, bucket)
    keep = torch.arange(64)[None, :] < plens[:, None]
    if not torch.equal(r_out[:, :64][keep], ragged[keep]):
        raise AssertionError("ragged prompts not preserved")
    print(f"spec ragged prompts (8-64 tokens): prompts kept, {r_steps} "
          f"steps, {r_per_step:.3f} committed tokens per step")

    greedy = SpecGenerator(model, max_new_tokens=max_new, temperature=0.0,
                           top_k=None, n_draft=N_DRAFT)
    g_out, g_steps, g_calls, g_launches = _spec_run(greedy, prompts)
    _, g_per_step = _check_spec_run(greedy, g_out, g_steps, g_calls,
                                    g_launches, device, PROMPT_LEN)
    print(f"spec greedy: {g_steps} steps, {g_per_step:.3f} committed tokens "
          f"per step")
    return gen, prompts, launches, n_steps, per_step


def _event_seconds(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


@torch.inference_mode()
def phase_spec_throughput(gen, prompts):
    """Spec tokens/s (B * 500 / time of one generate) beside the plain
    Generator on the same SPEC model (window 256: its own default, K1 at
    MHA), one generate each in the order plain, spec, spec, plain after a
    plain warm-up (the spec path is warm from its main-path runs)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    plain = Generator(gen.model, max_new_tokens=gen.max_new_tokens,
                      temperature=0.8, top_k=200)
    plain.generate(prompts, seed=99)
    seconds = {"plain": [], "spec": []}
    for i, name in enumerate(("plain", "spec", "spec", "plain")):
        g = plain if name == "plain" else gen
        seconds[name].append(_event_seconds(
            lambda: g.generate(prompts, seed=2000 + i)))
    n = prompts.shape[0] * gen.max_new_tokens
    tok_s = {k: n / (sum(v) / len(v)) for k, v in seconds.items()}
    print(f"throughput at B={prompts.shape[0]}, {gen.max_new_tokens} new "
          f"tokens: spec {tok_s['spec']:.1f} tok/s (generates "
          f"{seconds['spec']} s), plain Generator {tok_s['plain']:.1f} tok/s"
          f" ({seconds['plain']} s); spec/plain "
          f"{tok_s['spec'] / tok_s['plain']:.3f}")
    return tok_s


def _prefix_inputs(B, S, H, D, length, cache_dtype, seed=0, device="cpu"):
    """Operands of one valid-prefix decode call, made on ``device`` from a
    seed: q [B, HD] and the K/V cache [B, S, HD] in bf16 (K4), or bf16 q,
    an int8 cache and fp32 per-position scales [B, S] (K5, K6); every column
    from ``length`` on poisoned: NaN in the bf16 cache, int8 127 and scales
    1e4 in the int8 one (tests/test_decode_attention_int8.py:47-51).
    Returns (q, k, v, k_scale, v_scale, length tensor)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    HD = H * D
    q = torch.randn((B, HD), **kw).to(torch.bfloat16)
    n = torch.tensor(length, dtype=torch.int32, device=device)
    if cache_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (B, S, HD), dtype=torch.int8, **kw)
                for _ in range(2))
        k_scale, v_scale = (torch.rand((B, S), **kw) * 0.02 + 0.002
                            for _ in range(2))
        k[:, length:], v[:, length:] = 127, 127
        k_scale[:, length:], v_scale[:, length:] = 1e4, 1e4
        return q, k, v, k_scale, v_scale, n
    k, v = (torch.randn((B, S, HD), **kw).to(torch.bfloat16)
            for _ in range(2))
    k[:, length:], v[:, length:] = float("nan"), float("nan")
    return q, k, v, None, None, n


def _check_close(out, ref, what, frac=2.0 ** -7):
    """The kernel yardstick: finite, and within ``frac`` of the range of
    the twin evaluated in fp32 (by default one bf16 ulp of the largest
    value, 2^-7). Returns the error."""
    out = out.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"non-finite output: {what}")
    err = (out - ref).abs().max().item()
    tol = frac * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: differs from the fp32 twin by {err} > "
                             f"{tol}")
    return err


def phase_prefix_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64,
                                lengths=(1, 63, 64, 100, 255, 256)):
    """K4 against its twin evaluated in fp32 (q and the cache upcast
    exactly; TF32 off) at B=4096 and B=3, with every column from the length
    on NaN-poisoned. Returns the largest error."""
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference,
    )

    worst = 0.0
    for b in (B, 3):
        for length in lengths:
            q, k, v, _, _, n = _prefix_inputs(b, S, H, D, length,
                                              torch.bfloat16, seed=length,
                                              device=device)
            out = decode_attention(q, k, v, n, n_head=H)
            ref = decode_attention_reference(q.float(), k.float(), v.float(),
                                             n, n_head=H)
            worst = max(worst, _check_close(
                out, ref, f"decode_attention B={b} length={length}"))
            del q, k, v, out, ref
    print(f"decode_attention vs twin: B={B} and B=3, S={S}, H={H}, D={D}, "
          f"bf16, lengths {list(lengths)}, NaN past the length: finite, max "
          f"abs err {worst} vs the fp32 twin")
    return worst


def _prefix_work(q, k, k_scale, L):
    """(bytes, operations) of one valid-prefix call over L live columns:
    reads q, L columns of K and V and their scales; writes out."""
    B, S, HD = k.shape
    n = 2 * q.nbytes + 2 * B * L * HD * k.element_size()
    if k_scale is not None:
        n += 2 * B * L * k_scale.element_size()
    return n, 4 * B * L * HD


def phase_prefix_kernel_timing(B=BATCH, S=256, H=6, D=64, lengths=(128, 256)):
    """ms per call of K4, its plain twin, and the one PyTorch call that
    computes the same function (``scaled_dot_product_attention`` on the
    length-L prefix views) at the path's shape, B=4096 bf16, in the order
    plain, kernel, library, library, kernel, plain. The K+V prefix (0.8-1.6
    GB) exceeds the 50 MB L2, so every call reads it from device memory, as
    the decode loop does. Returns {L: the kernel's JSON numbers}."""
    import torch.nn.functional as F

    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference,
    )

    res = {}
    for L in lengths:
        q, k, v, _, _, n = _prefix_inputs(B, S, H, D, L, torch.bfloat16,
                                          seed=7, device="cuda")
        q4 = q.view(B, H, 1, D)
        k4, v4 = (t[:, :L].view(B, L, H, D).transpose(1, 2) for t in (k, v))
        times = {"plain": [], "kernel": [], "library": []}
        for order in ("plain", "kernel", "library", "library", "kernel",
                      "plain"):
            fn = {"plain": lambda: decode_attention_reference(
                      q, k, v, n, n_head=H),
                  "kernel": lambda: decode_attention(q, k, v, n, n_head=H),
                  "library": lambda: F.scaled_dot_product_attention(
                      q4, k4, v4)}[order]
            times[order].append(_cuda_ms(fn, 5 if order == "plain" else 50))
        bound_ms, bound_by = bound(*_prefix_work(q, k, None, L))
        res[L] = r = dict(ms=min(times["kernel"]),
                          plain_ms=min(times["plain"]), bound_ms=bound_ms,
                          bound_by=bound_by,
                          library_ms=min(times["library"]))
        print(f"decode_attention at B={B} S={S} length {L} bf16: kernel "
              f"{times['kernel']} ms/call, twin {times['plain']}, "
              f"scaled_dot_product_attention {times['library']} (plain, "
              f"kernel, library, library, kernel, plain); bound "
              f"{bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / r['ms']:.3f} of it, library at "
              f"{bound_ms / r['library_ms']:.3f}")
        del q, k, v, q4, k4, v4
    return res


@torch.inference_mode()
def phase_pallas_main_path(device, B=BATCH, max_new=MAX_NEW):
    """The attn_impl="pallas" path through Generator at its default window
    (256): two same-seed generates, checked, each with exactly n_layer *
    max_new K4 launches and no K1 launch on the card (none of either on
    the CPU, where the twins run). Returns (generator, prompts, K4
    launches per generate)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update

    _, model = _bench_model(device, PALLAS)
    cfg = model.config
    gen = Generator(model, max_new_tokens=max_new, temperature=0.8,
                    top_k=200)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32)
    runs = []
    for _ in range(2):
        decode_attention.launches = gqa_decode_update.launches = 0
        out = gen.generate(prompts, seed=1234)
        _sync(device)
        runs.append((out.cpu(), (decode_attention.launches,
                                 gqa_decode_update.launches)))
    (out, launches), (again, launches2) = runs
    if out.shape != (B, PROMPT_LEN + max_new):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError("prompts not preserved")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("token out of range")
    if not torch.equal(out, again):
        raise AssertionError("same seed gave different tokens")
    cuda = torch.device(device).type == "cuda"
    want = (cfg.n_layer * max_new if cuda else 0, 0)
    if not launches == launches2 == want:
        raise AssertionError(f"(K4, K1) launches per generate {launches}, "
                             f"{launches2} != {want}")
    print(f"pallas main path: generate [{B}, {PROMPT_LEN}] -> "
          f"{tuple(out.shape)} at window {gen.window}, prompts kept, tokens "
          f"in range, same seed identical, {launches[0]} K4 launches and "
          f"{launches[1]} K1 launches per generate")
    return gen, prompts, launches[0]


@torch.inference_mode()
def phase_pallas_throughput(gen, prompts):
    """Tokens/s and peak memory of the pallas path (K4) beside the same
    weights with attn_impl="xla" (K1 at MHA bf16), one generate each in the
    order xla, pallas, pallas, xla after an xla warm-up (the pallas path is
    warm from its main-path runs). Printed, not gated."""
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    device = gen.model.transformer.wte.weight.device
    xla_model = GPT(GPTConfig(**dict(PALLAS, attn_impl="xla")), device=device)
    xla_model.load_state_dict(gen.model.state_dict())
    xla = Generator(xla_model.eval(),
                    max_new_tokens=gen.max_new_tokens, temperature=0.8,
                    top_k=200)
    xla.generate(prompts, seed=99)
    seconds = {"xla": [], "pallas": []}
    peak = {}
    for i, name in enumerate(("xla", "pallas", "pallas", "xla")):
        g = xla if name == "xla" else gen
        torch.cuda.reset_peak_memory_stats()
        seconds[name].append(_event_seconds(
            lambda: g.generate(prompts, seed=3000 + i)))
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    n = prompts.shape[0] * gen.max_new_tokens
    tok_s = {k: n / (sum(v) / len(v)) for k, v in seconds.items()}
    print(f"pallas path at B={prompts.shape[0]}, {gen.max_new_tokens} new "
          f"tokens, window {gen.window}: {tok_s['pallas']:.1f} tok/s "
          f"(generates {seconds['pallas']} s, peak {peak['pallas']:.2f} "
          f"GiB) vs attn_impl=xla (K1) {tok_s['xla']:.1f} tok/s "
          f"({seconds['xla']} s, peak {peak['xla']:.2f} GiB); pallas/xla "
          f"{tok_s['pallas'] / tok_s['xla']:.3f}")
    return tok_s


INT8_VARIANTS = (("decode_attention_int8", 1),
                 ("decode_attention_int8_multirow", 1),
                 ("decode_attention_int8_multirow", 8))


def _int8_call(name, rows, q, k, v, k_scale, v_scale, n, H):
    from ai_music_generation_tpu_torch.ops import decode_attention_int8 as ops

    if name == "decode_attention_int8":
        B, S = k_scale.shape
        return ops.decode_attention_int8(
            q, k, v, k_scale.view(B, 1, S), v_scale.view(B, 1, S), n,
            n_head=H)
    return ops.decode_attention_int8_multirow(q, k, v, k_scale, v_scale, n,
                                              n_head=H, rows_per_program=rows)


def phase_int8_kernel_vs_twin(device, B=BATCH, S=256, H=6, D=64,
                              lengths=(1, 127, 128, 200, 256)):
    """K5 and K6 (R = 1 and 8) against their twin evaluated in fp32 (q
    upcast exactly) at B=4096 and B=16, every column from the length on
    poisoned (int8 127, scales 1e4). Returns the largest error of each."""
    from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
        decode_attention_int8_reference,
    )

    worst = {name: 0.0 for name, _ in INT8_VARIANTS}
    for b in (B, 16):
        for length in lengths:
            x = _prefix_inputs(b, S, H, D, length, torch.int8, seed=length,
                               device=device)
            ref = decode_attention_int8_reference(x[0].float(), *x[1:],
                                                  n_head=H)
            for name, rows in INT8_VARIANTS:
                out = _int8_call(name, rows, *x, H)
                worst[name] = max(worst[name], _check_close(
                    out, ref, f"{name} R={rows} B={b} length={length}"))
            del x, ref, out
    print(f"int8 decode attention vs twin: K5 and K6 (R 1, 8) at B={B} and "
          f"B=16, S={S}, lengths {list(lengths)}, poisoned past the length: "
          f"finite, max abs err vs the fp32 twin {worst}")
    return worst


def phase_int8_kernel_timing(B=BATCH, S=256, H=6, D=64, L=256):
    """ms per call of K5, K6 (R=8, the JAX default; the kernel launches one
    block per (row, head) whatever R is) and their plain twin at B=4096,
    every column live, in the order plain, K5, K6, K6, K5, plain. No one
    PyTorch call dequantizes a per-position int8 cache, so there is no
    library time. Returns {name: the kernel's JSON numbers}."""
    from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
        decode_attention_int8_reference,
    )

    x = _prefix_inputs(B, S, H, D, L, torch.int8, seed=8, device="cuda")
    variants = (("decode_attention_int8", 1),
                ("decode_attention_int8_multirow", 8))
    order = [None, *variants, *variants[::-1], None]
    times = {v: [] for v in order}
    for v in order:
        if v is None:
            times[v].append(_cuda_ms(lambda: decode_attention_int8_reference(
                *x, n_head=H), 5))
        else:
            times[v].append(_cuda_ms(lambda: _int8_call(*v, *x, H), 50))
    bound_ms, bound_by = bound(*_prefix_work(x[0], x[1], x[3], L))
    plain_ms = min(times[None])
    res = {}
    for name, rows in variants:
        ms = min(times[(name, rows)])
        print(f"{name} R={rows} at B={B} S={S} length {L} int8: kernel "
              f"{times[(name, rows)]} ms/call, twin {times[None]}; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    return res


def _lean_layer(name, B, S, seed, device):
    """One probe layer of mode ``name`` and its query, made on ``device``
    from a seed (experiments/int4_kernel_probe.py::random_layer): (q, k, v,
    k_scale, v_scale)."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    layer = probe.random_layer(name, B, S, g)
    return (probe.random_query(name, B, g), *layer)


def phase_lean_kernel_vs_twin(device, B=BATCH, S=256):
    """K7 in both modes against its twin evaluated in fp32 on the CPU, at
    B=4096 and B=3, S=256 and S=16: finite and within 2^-6 of the range,
    the room for one p8 (lean8) or bf16-probability (lean4) rounding flip,
    which fp32 sums taken in another order than the twin's can cause at a
    tie (K2's int8_dots yardstick). The CPU twin is the one that
    tests/test_torch_lean_attention.py holds to the JAX kernel. Returns the
    largest error of each mode."""
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention, lean_attention_reference,
    )

    worst = {name: 0.0 for name in LEAN_MODES}
    for b in (B, 3):
        for s in (S, 16):
            for name in LEAN_MODES:
                x = _lean_layer(name, b, s, seed=b + s, device=device)
                packed = name == "lean4"
                out = lean_attention(*x, packed)
                ref = lean_attention_reference(*(t.cpu() for t in x), packed)
                worst[name] = max(worst[name], _check_close(
                    out.cpu(), ref, f"lean_attention {name} B={b} S={s}",
                    frac=2.0 ** -6))
                del x, out, ref
    print(f"lean_attention vs twin: lean8 and lean4 at B={B} and B=3, S={S} "
          f"and S=16: finite, max abs err vs the fp32 twin {worst}")
    return worst


def _lean_work(x, name):
    """(bytes, operations, peak rate) of one lean call: reads q, K, V and
    their scales once, writes the fp32 output; QK and PV 2 operations per
    (row, lane, position) each, int8 x int8 in lean8, bf16 in lean4."""
    q, k, v, ks, vs = x
    B, HD = q.shape
    S = ks.shape[-1]
    n = sum(t.nbytes for t in x) + 4 * B * HD
    rate = INT8_OPS_PER_S if name == "lean8" else BF16_OPS_PER_S
    return n, 4 * B * HD * S, rate


def phase_lean_kernel_timing(B=BATCH, S=256):
    """ms per call of K7 in both modes and of their twins at B=4096, S=256,
    in the order plain, lean8, lean4, lean4, lean8, plain (each plain slot
    times both twins). The caches (0.4-0.8 GB) exceed the 50 MB L2, so every
    call reads them from device memory. No one PyTorch call does int8 x
    int8 dots with per-row requantized q and probabilities, or unpacks a
    position-packed int4 cache, so there is no library time. Returns
    {mode: the kernel's JSON numbers}."""
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention, lean_attention_reference,
    )

    x = {name: _lean_layer(name, B, S, seed=9, device="cuda")
         for name in LEAN_MODES}
    kernel = {name: [] for name in LEAN_MODES}
    plain = {name: [] for name in LEAN_MODES}
    for slot in ("plain", "lean8", "lean4", "lean4", "lean8", "plain"):
        for name in (LEAN_MODES if slot == "plain" else (slot,)):
            packed = name == "lean4"
            if slot == "plain":
                plain[name].append(_cuda_ms(
                    lambda: lean_attention_reference(*x[name], packed), 5))
            else:
                kernel[name].append(_cuda_ms(
                    lambda: lean_attention(*x[name], packed), 50))
    res = {}
    for name in LEAN_MODES:
        n_bytes, n_ops, rate = _lean_work(x[name], name)
        bound_ms, bound_by = bound(n_bytes, n_ops, rate)
        res[name] = r = dict(ms=min(kernel[name]), plain_ms=min(plain[name]),
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
        print(f"lean_attention {name} at B={B} S={S}: kernel {kernel[name]} "
              f"ms/call, twin {plain[name]} (plain, lean8, lean4, lean4, "
              f"lean8, plain); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{n_bytes / 1e6:.1f} MB), {bound_ms / r['ms']:.3f} of it")
    return res


@torch.inference_mode()
def phase_probe_main_path(device, B=BATCH, S=256, iters=3):
    """The probe path through its entry point, ``run_variant``, at full
    width for xla8, lean8 and lean4: each lean step launches K7 once per
    layer (none on the CPU, where the twin runs; none for xla8), and the
    final q is finite. Returns {variant: run_variant's result}."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention,
    )

    cuda = torch.device(device).type == "cuda"
    res = {}
    for name in ("xla8", "lean8", "lean4"):
        before = lean_attention.launches
        r = probe.run_variant(name, batch=B, seq=S, device=device,
                              iters=iters)
        launches = lean_attention.launches - before
        want = probe.L * r["steps"] if cuda and name != "xla8" else 0
        if launches != want:
            raise AssertionError(f"probe {name}: {launches} K7 launches for "
                                 f"{r['steps']} steps, want {want}")
        if not torch.isfinite(r["q"].float()).all():
            raise AssertionError(f"probe {name}: non-finite q")
        ms = r["ms_per_layer"]
        timing = ("not timed" if ms is None else
                  f"{ms:.4f} ms per layer-read, {r['floor_ms'] / ms:.3f} of "
                  f"the floor")
        print(f"probe {name} at B={B} S={S}, {probe.L} layers: {r['steps']} "
              f"steps, {launches} K7 launches, final q finite; floor "
              f"{r['floor_ms']:.4f} ms ({r['floor_bytes'] / 1e6:.1f} MB); "
              f"{timing}")
        res[name] = r
    return res


@torch.inference_mode()
def phase_probe_vs_twin(res, rows=3):
    """One lean8 and one lean4 probe step on a ``rows``-row slice of phase
    15's caches, on their device, against the twin on the CPU applied layer
    by layer to the same inputs (each layer's q as the step saw it: a
    rounding flip in one layer would otherwise carry into the next layer's
    requantized q): within the phase-14 yardstick. Returns the largest
    error."""
    from ai_music_generation_tpu_torch.experiments import (
        int4_kernel_probe as probe,
    )
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention_reference,
    )

    worst = 0.0
    for name in LEAN_MODES:
        packed = name == "lean4"
        layers = [tuple(t[:rows].contiguous() for t in layer)
                  for layer in res[name]["layers"]]
        record = []
        q = probe.lean_step(res[name]["q0"][:rows].contiguous(), layers,
                            packed, record=record)
        if not torch.isfinite(q.float()).all():
            raise AssertionError(f"probe {name} slice: non-finite q")
        for i, ((q_in, o), layer) in enumerate(zip(record, layers)):
            ref = lean_attention_reference(
                q_in.cpu(), *(t.cpu() for t in layer), packed)
            worst = max(worst, _check_close(
                o.cpu(), ref, f"probe {name} layer {i}", frac=2.0 ** -6))
    print(f"probe steps on a {rows}-row slice vs the twin, layer by layer: "
          f"max abs err {worst}")
    return worst


PROFILED = ("pallas", "bench", "spec")


@torch.inference_mode()
def phase_profile(path="pallas", B=BATCH, max_new=MAX_NEW, top=12) -> None:
    """One generate of ``path`` (pallas: phase 12's protocol, bench: phase
    5's, spec: phase 8's) under ``torch.profiler`` (CPU and CUDA
    activities) after a warm-up and an unprofiled generate timed with CUDA
    events: device self time by kernel, summed only over entries whose
    device type is not the CPU (a CPU op's entry repeats its kernels'
    device time), and the device's busy share of the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.decode.speculative import (
        SpecGenerator,
    )

    _, model = _bench_model("cuda", {"pallas": PALLAS, "bench": BENCH,
                                     "spec": SPEC}[path])
    kw = dict(max_new_tokens=max_new, temperature=0.8, top_k=200)
    gen = (SpecGenerator(model, n_draft=N_DRAFT, **kw) if path == "spec"
           else Generator(model, window=WINDOW, **kw) if path == "bench"
           else Generator(model, **kw))
    prompts = torch.randint(0, model.config.vocab_size, (B, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(6),
                            dtype=torch.int32)
    gen.generate(prompts, seed=1)
    wall = _event_seconds(lambda: gen.generate(prompts, seed=2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(prompts, seed=3)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile {path}: B={B}, {max_new} new tokens, window "
          f"{gen.window}; unprofiled generate {wall:.3f} s, profiled "
          f"{profiled:.3f} s; device busy {busy_ms:.1f} ms = "
          f"{busy_ms / 1e3 / profiled:.3f} of the profiled wall, "
          f"{busy_ms / 1e3 / wall:.3f} of the unprofiled one")
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.1f} ms {count:7d} calls  {ms / count:.4f} ms/call  "
              f"{key[:90]}")


def _counted_ops() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from ai_music_generation_tpu_torch.ops import decode_attention_int8 as i8
    from ai_music_generation_tpu_torch.ops.decode_attention import (
        decode_attention,
    )
    from ai_music_generation_tpu_torch.ops.gqa_decode import gqa_decode_update
    from ai_music_generation_tpu_torch.ops.lean_attention import (
        lean_attention,
    )
    from ai_music_generation_tpu_torch.ops.spec_attention import (
        spec_attention, spec_attention_update,
    )

    return {f.__name__: f for f in (
        gqa_decode_update, spec_attention_update, spec_attention,
        decode_attention, i8.decode_attention_int8,
        i8.decode_attention_int8_multirow, lean_attention)}


def _main_path(phase, *args):
    """Run a main-path phase with every kernel's launch count set to 0 just
    before it; returns the phase's result and the counts just after."""
    ops = _counted_ops()
    for f in ops.values():
        f.launches = 0
    result = phase(*args)
    return result, {name: f.launches for name, f in ops.items()}


def _entry(name, source, replaces, launches, err, numbers, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, **numbers, **extra)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", nargs="?", const="pallas",
                        metavar="PATHS",
                        help="only build, then profile one generate of each "
                             f"of the comma-separated paths (of "
                             f"{', '.join(PROFILED)}; default pallas): no "
                             "checks, no JSON result")
    args = parser.parse_args(argv)
    if args.profile and not set(args.profile.split(",")) <= set(PROFILED):
        parser.error(f"--profile takes paths of {PROFILED}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    if args.profile:
        for path in args.profile.split(","):
            phase_profile(path)
            torch.cuda.empty_cache()
        return 0
    err = phase_kernel_vs_twin("cuda")
    k1 = phase_kernel_timing()
    phase_model("cuda")
    (gen, prompts, launches), on_path = _main_path(phase_main_path,
                                                   "cuda")
    tok_s = phase_throughput(gen, prompts)
    print(f"[{card}] decode {tok_s:.1f} tokens/s at batch {BATCH}, "
          f"{MAX_NEW} new tokens, window {WINDOW}; gqa_decode kernel "
          f"{k1['ms']:.4f} ms/call, plain twin {k1['plain_ms']:.4f} ms/call")
    kernels = [_entry("gqa_decode_update", KERNEL_SOURCE, KERNEL_REPLACES,
                      launches, err, k1)]
    del gen, prompts
    torch.cuda.empty_cache()

    ops = _counted_ops()
    ops["spec_attention"].launches = 0
    spec_err = phase_spec_kernel_vs_twin("cuda")
    k3_checks = ops["spec_attention"].launches
    spec_ms = phase_spec_kernel_timing()
    phase_spec_model("cuda")
    (gen, prompts, spec_launches, n_steps, per_step), counts = _main_path(
        phase_spec_main_path, "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    spec_tok_s = phase_spec_throughput(gen, prompts)
    verify, refresh = spec_ms["spec_attention_update"], spec_ms["refresh"]
    print(f"[{card}] spec decode {spec_tok_s['spec']:.1f} tokens/s "
          f"({per_step:.3f} committed tokens per step, {n_steps} steps) vs "
          f"plain {spec_tok_s['plain']:.1f} tokens/s on the SPEC model; "
          f"spec_attention_update {verify['ms']:.4f} ms/call at T=5 "
          f"(twin {verify['plain_ms']:.4f}), {refresh['ms']:.4f} ms at "
          f"T=128 (twin {refresh['plain_ms']:.4f})")
    kernels.append(_entry("spec_attention_update", SPEC_SOURCE,
                          SPEC_REPLACES["spec_attention_update"],
                          spec_launches, spec_err["spec_attention_update"],
                          verify, refresh=refresh))
    del gen, prompts
    torch.cuda.empty_cache()

    k4_err = phase_prefix_kernel_vs_twin("cuda")
    k4 = phase_prefix_kernel_timing()
    phase_model("cuda", config=PALLAS, window=None)
    (gen, prompts, k4_launches), counts = _main_path(phase_pallas_main_path,
                                                     "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    pallas_tok_s = phase_pallas_throughput(gen, prompts)
    print(f"[{card}] pallas decode {pallas_tok_s['pallas']:.1f} tokens/s vs "
          f"xla (K1) {pallas_tok_s['xla']:.1f} tokens/s at batch {BATCH}, "
          f"{MAX_NEW} new tokens, window 256; decode_attention "
          f"{k4[128]['ms']:.4f} ms/call at length 128, {k4[256]['ms']:.4f} "
          f"at 256")
    kernels.append(_entry("decode_attention", PREFIX_SOURCE,
                          PREFIX_REPLACES["decode_attention"], k4_launches,
                          k4_err, k4[256]))
    del gen, prompts
    torch.cuda.empty_cache()

    ops["decode_attention_int8"].launches = 0
    ops["decode_attention_int8_multirow"].launches = 0
    int8_err = phase_int8_kernel_vs_twin("cuda")
    int8_checks = {name: ops[name].launches for name in int8_err}
    int8_ms = phase_int8_kernel_timing()

    lean_err = phase_lean_kernel_vs_twin("cuda")
    lean_ms = phase_lean_kernel_timing()
    probe, counts = _main_path(phase_probe_main_path, "cuda")
    on_path = {k: n + counts[k] for k, n in on_path.items()}
    probe_err = phase_probe_vs_twin(probe)
    print(f"[{card}] probe at B={BATCH}, S=256, 6 layers: "
          + ", ".join(f"{n} {r['ms_per_layer']:.4f} ms per layer-read "
                      f"(floor {r['floor_ms']:.4f})" for n, r in probe.items())
          + f"; lean_attention lean8 {lean_ms['lean8']['ms']:.4f} ms/call, "
          f"lean4 {lean_ms['lean4']['ms']:.4f}")
    del probe
    torch.cuda.empty_cache()
    # K3, K5 and K6 have no caller on any path: their launches are the sum
    # of their counts over the four main paths (phases 5, 8, 12 and 15)
    kernels.append(_entry("spec_attention", SPEC_SOURCE,
                          SPEC_REPLACES["spec_attention"],
                          on_path["spec_attention"],
                          spec_err["spec_attention"],
                          spec_ms["spec_attention"], check_launches=k3_checks))
    for name in int8_err:
        kernels.append(_entry(name, PREFIX_SOURCE, PREFIX_REPLACES[name],
                              on_path[name], int8_err[name], int8_ms[name],
                              check_launches=int8_checks[name]))
    # K7's numbers are lean4's (the probe's position-packed int4 cache);
    # each mode's own are under "modes"
    kernels.append(_entry(
        "lean_attention", LEAN_SOURCE, LEAN_REPLACES,
        on_path["lean_attention"], max(*lean_err.values(), probe_err),
        lean_ms["lean4"], modes={name: dict(lean_ms[name],
                                            max_abs_err=lean_err[name])
                                 for name in LEAN_MODES}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
