"""Drive the PyTorch port's batched ABC decode path once on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing a result):

1. environment: the card (name and power limit from nvidia-smi), torch,
   CUDA, nvcc, ninja, triton; TF32 off for every fp32 product;
2. build: the CUDA kernels, compiled from ``ai_music_generation_tpu_torch/
   ops/csrc`` (nvcc's register/shared-memory report is printed);
3. kernel vs plain twin at the batched decode shape (B=4096, S=128, H=6,
   KH=2, D=64) in all four modes (int8/bf16 cache x lockstep/ring mask),
   pos in {0, 7, 8, 127}, plus a 3-row batch: caches and scales bit-exact,
   the output within one bf16 ulp of its range of the twin evaluated in
   fp32; then both timed on the card;
4. model: the bench-config GPT (6 layers, 6 heads, 384 wide, block 256,
   vocab 128, KH=2, int8 cache) on the card against the same weights on the
   CPU: prefill plus 16 decode steps, logits compared for 8 rows;
5. main path: ``Generator(window=128, max_new_tokens=500, temperature=0.8,
   top_k=200)`` at batch 4096 with 8-token prompts: shape, prompts kept,
   token range, same-seed determinism, and exactly n_layer * 500 kernel
   launches per generate; then decode throughput timed with CUDA events.

The last two lines are a JSON summary of each kernel and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
KERNEL_SOURCE = "ai_music_generation_tpu_torch/ops/csrc/gqa_decode.cu"
KERNEL_REPLACES = "ai_music_generation_tpu/ops/gqa_decode.py:394"


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
    for b in (B, 3):
        for quant in (True, False):
            for ring in (False, True):
                for pos in (0, 7, 8, S - 1):
                    cpu = _decode_inputs(quant, ring, pos, b, S)
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
                                f"{name} differs: B={b} quant={quant} "
                                f"ring={ring} pos={pos}")
                    out = out.float().cpu()
                    err = (out - ref32).abs().max().item()
                    tol = 2.0 ** -7 * ref32.abs().max().item()
                    if not err <= tol:
                        raise AssertionError(
                            f"out differs from the fp32 twin by {err} > "
                            f"{tol}: B={b} quant={quant} ring={ring} "
                            f"pos={pos}")
                    worst32 = max(worst32, err)
                    worst16 = max(worst16,
                                  (out - ref.float()).abs().max().item())
    print(f"kernel vs twin: 4 modes x pos (0, 7, 8, {S - 1}) at B={B} and "
          f"B=3, S={S}: caches and scales bit-exact; out max abs err "
          f"{worst32} vs the fp32 twin, {worst16} vs the bf16 twin")
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


def phase_kernel_timing(B=BATCH, S=WINDOW) -> tuple[float, float]:
    """ms per call of the kernel and of the plain twin on the card, at the
    decode shape, int8 lockstep at pos = S-1 (the whole window valid). The
    K+V caches (128 MiB at B=4096) exceed the 50 MB L2, so every call reads
    them from device memory, as the decode loop does."""
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
    print(f"gqa_decode at B={B} S={S} int8: kernel {kernel} ms/call, twin "
          f"{plain} ms/call (plain, kernel, kernel, plain); best kernel "
          f"{ms:.4f} ms = {cache_bytes / ms / 1e6:.1f} GB/s of cache read, "
          f"twin {plain_ms:.4f} ms")
    return ms, plain_ms


def _bench_model(device):
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

    model = GPT(GPTConfig(**BENCH))
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval(), copy.deepcopy(model).to(device).eval()


@torch.inference_mode()
def phase_model(device, B=BATCH, rows=8, steps=16) -> None:
    """Teacher-forced prefill + decode steps on the card and on the CPU with
    the same weights; bf16 logits agree within 2^-4 of their range (8 bf16
    ulps at the largest logit: cuBLAS and the kernel round at other places
    than the CPU's matmuls and the twin, over 6 layers)."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    cpu_model, model = _bench_model(device)
    cfg = model.config
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN + steps),
                        generator=g, dtype=torch.int32)
    caches = (KVCache.create(cfg, B, WINDOW, device=device),
              KVCache.create(cfg, rows, WINDOW))
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
    print(f"model: prefill {PROMPT_LEN} + {steps} decode steps at B={B}, "
          f"{rows} rows vs CPU: logits max abs err {worst} (tol {tol})")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    err = phase_kernel_vs_twin("cuda")
    ms, plain_ms = phase_kernel_timing()
    phase_model("cuda")
    gen, prompts, launches = phase_main_path("cuda")
    tok_s = phase_throughput(gen, prompts)
    print(f"[{card}] decode {tok_s:.1f} tokens/s at batch {BATCH}, "
          f"{MAX_NEW} new tokens, window {WINDOW}; gqa_decode kernel "
          f"{ms:.4f} ms/call, plain twin {plain_ms:.4f} ms/call")
    print(json.dumps({"kernels": [{
        "name": "gqa_decode_update", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
