"""The port's program spans (``utils/tracing.py``) and its weight-cast
counter (``models/gpt.py::cast_param``), on the CPU.

- outside a profiler a span is the one shared no-op context;
- under ``torch.profiler`` (CPU activity) a tiny windowed ``Generator``, a
  train step at accumulation 2 and ``BinDataset.sharded_sample`` show each
  span as often as the shapes say, nested as the call tree is;
- tokens, the loss, the gradients (AdamW's first moment after one step)
  and the parameters are the same with and without the profiler;
- under the profiler the cast counter counts a forward's parameter casts
  to the byte (every parameter but LayerNorm's and the MoE router's,
  ``numel x (4 + 2)`` for fp32 -> bf16), and nothing when the parameters
  are already in the compute dtype; without a profiler neither it nor the
  forward counter moves.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ai_music_generation_tpu_torch.data.memmap import BinDataset
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, cast_param
from ai_music_generation_tpu_torch.train.optimizer import make_optimizer
from ai_music_generation_tpu_torch.train.step import make_train_step
from ai_music_generation_tpu_torch.utils import tracing

torch.set_num_threads(1)

SPANS = set(tracing.DECODE_LOOP + tracing.MODEL + tracing.K1
            + tracing.TRAIN_STEP)
# a windowed decode: prompt 4 (the prefill bucket), 20 new tokens, window
# 16 refreshed every 8: steps 4..15, one refresh, steps 16..23
N_LAYER, PROMPT, NEW, WINDOW, REFRESH = 2, 4, 20, 16, 8
STEPS, REFRESHES = NEW, 1


def _model(dropout=0.0, param_dtype=torch.float32, dtype=torch.bfloat16,
           bias=False, **sizes):
    cfg = GPTConfig(**{**dict(block_size=32, vocab_size=48, n_layer=N_LAYER,
                              n_head=4, n_embd=64, n_kv_head=2), **sizes},
                    bias=bias, dropout=dropout, dtype=dtype,
                    param_dtype=param_dtype, kv_quantized=True, flat_kv=True)
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _traced(fn, on):
    """(fn's result, [(span name, start ns, end ns)] of the program's
    spans; [] when ``on`` is false: no profiler)."""
    if not on:
        return fn(), []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU and e.name() in SPANS]
    return out, spans


def _count(spans):
    counts = dict.fromkeys(SPANS, 0)
    for name, _, _ in spans:
        counts[name] += 1
    return counts


def _inside(spans, inner, outers):
    """Every ``inner`` span lies within one of the ``outers`` spans."""
    around = [(s, e) for n, s, e in spans if n in outers]
    return all(any(s0 <= s and e <= e0 for s0, e0 in around)
               for n, s, e in spans if n == inner)


def _generate(on, temperature=0.8):
    model = _model().eval()
    gen = Generator(model, max_new_tokens=NEW, temperature=temperature,
                    top_k=20, window=WINDOW, refresh=REFRESH)
    prompts = torch.randint(0, 48, (3, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    return _traced(lambda: gen.generate(prompts, seed=7), on)


def test_span_is_one_shared_no_op_outside_a_profiler():
    a, b = tracing.span(tracing.DECODE_STEP), tracing.span("another")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(tracing.span(tracing.DECODE_STEP),
                              contextlib.nullcontext)


def test_generate_spans_count_what_the_shapes_say():
    _, spans = _generate(True)
    calls = 1 + REFRESHES + STEPS  # the prefill, the refresh, the steps
    assert _count(spans) == {
        tracing.DECODE_PREFILL: 1, tracing.DECODE_STEP: STEPS,
        tracing.DECODE_SAMPLE: STEPS, tracing.DECODE_REFRESH: REFRESHES,
        tracing.GPT_FORWARD: calls, tracing.GPT_BLOCK: N_LAYER * calls,
        # one K1 call a layer a T=1 step over the flat cache
        tracing.K1_UPDATE: N_LAYER * STEPS,
        tracing.TRAIN_FORWARD: 0, tracing.TRAIN_BACKWARD: 0,
        tracing.TRAIN_CLIP: 0, tracing.TRAIN_OPTIMIZER: 0,
        tracing.DATA_SAMPLE: 0}


@pytest.mark.parametrize("inner,outers", [
    (tracing.DECODE_SAMPLE, {tracing.DECODE_STEP}),
    (tracing.GPT_FORWARD, {tracing.DECODE_PREFILL, tracing.DECODE_STEP,
                           tracing.DECODE_REFRESH}),
    (tracing.GPT_BLOCK, {tracing.GPT_FORWARD}),
    (tracing.K1_UPDATE, {tracing.GPT_BLOCK}),
])
def test_generate_spans_nest_as_the_calls(inner, outers):
    _, spans = _generate(True)
    assert any(n == inner for n, _, _ in spans)
    assert _inside(spans, inner, outers)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_do_not_depend_on_the_profiler(temperature):
    plain, _ = _generate(False, temperature)
    traced, spans = _generate(True, temperature)
    assert spans
    assert torch.equal(plain, traced)


def _train(on, accum=2):
    """(loss, grad_norm, AdamW's first moments, parameters, spans) of one
    step at ``accum`` micro-steps, dropout on."""
    model = _model(dropout=0.1, param_dtype=torch.float32,
                   dtype=torch.float32)
    opt = make_optimizer(model, 1e-3, 0.1, 0.9, 0.95)
    step = make_train_step(model, opt, None, 1.0)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.integers(0, 48, (accum, 2, 32)))
            for _ in range(2))
    metrics, spans = _traced(lambda: step(x, y, 0, seed=5), on)
    moments = [opt.state[p]["exp_avg"] for p in model.parameters()]
    return metrics, moments, list(model.parameters()), spans


def test_train_step_spans_count_each_micro_step():
    _, _, _, spans = _train(True, accum=2)
    counts = _count(spans)
    assert {n: counts[n] for n in tracing.TRAIN_STEP} == {
        tracing.TRAIN_FORWARD: 2, tracing.TRAIN_BACKWARD: 2,
        tracing.TRAIN_CLIP: 1, tracing.TRAIN_OPTIMIZER: 1,
        tracing.DATA_SAMPLE: 0}
    assert counts[tracing.GPT_FORWARD] == 2
    assert _inside(spans, tracing.GPT_FORWARD, {tracing.TRAIN_FORWARD})


def test_train_step_does_not_depend_on_the_profiler():
    plain = _train(False)
    traced = _train(True)
    assert traced[3]
    for key in ("loss", "grad_norm"):
        assert torch.equal(plain[0][key], traced[0][key]), key
    assert plain[0]["lr"] == traced[0]["lr"]
    for got, want in zip(traced[1] + traced[2], plain[1] + plain[2]):
        assert torch.equal(got, want)


def test_sharded_sample_is_a_span(tmp_path):
    path = str(tmp_path / "train.bin")
    np.arange(1000, dtype=np.uint16).tofile(path)
    data = BinDataset(path, dtype=np.uint16)
    plain = data.sharded_sample(1, 2, (2, 3), 16, (0, 1))
    traced, spans = _traced(
        lambda: data.sharded_sample(1, 2, (2, 3), 16, (0, 1)), True)
    assert _count(spans)[tracing.DATA_SAMPLE] == 1
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def _cast_bytes_of_one_forward(model, traced=True, **kwargs):
    """The cast bytes and forwards counted over one forward, under a CPU
    profiler or without one."""
    idx = torch.zeros((1, 4), dtype=torch.long,
                      device=next(model.parameters()).device)
    bytes0, calls0 = cast_param.bytes, GPT.forward.calls
    with (profile(activities=[ProfilerActivity.CPU]) if traced
          else contextlib.nullcontext()), torch.no_grad():
        model(idx, **kwargs)
    assert GPT.forward.calls - calls0 == int(traced)
    return cast_param.bytes - bytes0


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("param_dtype,dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
def test_cast_counter_counts_a_forwards_parameter_casts(param_dtype, dtype,
                                                        bias):
    model = _model(param_dtype=param_dtype, dtype=dtype, bias=bias).eval()
    cast = sum(p.numel() for name, p in model.named_parameters()
               if ".ln_" not in name)
    want = (0 if param_dtype == dtype else
            cast * (param_dtype.itemsize + dtype.itemsize))
    assert _cast_bytes_of_one_forward(model) == want
    assert _cast_bytes_of_one_forward(
        model, targets=torch.zeros((1, 4), dtype=torch.long)) == want


@pytest.mark.parametrize("n_expert", [0, 4])
def test_cast_counter_counts_nothing_without_a_profiler(n_expert):
    """Untraced, a cast and a forward pay a flag read: no counter moves."""
    model = _model(param_dtype=torch.float32, dtype=torch.bfloat16,
                   bias=True, n_expert=n_expert).eval()
    assert _cast_bytes_of_one_forward(model, traced=False) == 0


@pytest.mark.parametrize("sizes,params", [
    # the music model: 6 layers, 6 heads (2 kv-heads), 384 wide, block
    # 256, vocab 128, no bias
    (dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384,
          n_kv_head=2, bias=False), 9_584_640),
    # GPT-2 124M: 12 layers, 12 heads, 768 wide, block 1024, vocab 50257
    (dict(block_size=1024, vocab_size=50257, n_layer=12, n_head=12,
          n_embd=768, n_kv_head=None, bias=True), 124_401_408),
    # the music model with 4 routed experts (top 2) in every block: the
    # experts' weights cast, the fp32 router not
    (dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384,
          n_kv_head=2, bias=False, n_expert=4, expert_top_k=2), 30_818_304),
], ids=["music_gqa", "gpt2_124m", "music_gqa_moe4"])
def test_cast_counter_at_the_benchmark_sizes(sizes, params):
    """The parameters a decode forward casts (every one but LayerNorm's
    and the router's, the tied head once), 6 bytes each: 57,507,840 and
    746,408,448 bytes for the benchmark's models. On the meta device:
    shapes only."""
    model = GPT(GPTConfig(**sizes), device="meta").eval()
    assert _cast_bytes_of_one_forward(model) == params * 6
