"""The readers of the program's spans and weight-cast counter
(``metrics/{loop,model,k1}_idle.decode.py``, ``model_idle.train.py``,
``step_idle.train.py``, ``weight_cast_mb.decode.py``): their values on a
trace summary made by hand; None without a trace, with an empty window and
with a program that has no spans or counters (the modules or names gone);
and, on the card, a traced tiny generate whose idle gaps carry the
program's span names while its device operations carry none, with the
same tokens as an untraced one."""

import sys
import types

import pytest
import torch

from port_bench.harness import spec, trace
from port_bench.harness.runner import Record

SPAN_READERS = ("loop_idle.decode", "model_idle.decode", "k1_idle.decode",
                "model_idle.train", "step_idle.train")
READERS = SPAN_READERS + ("weight_cast_mb.decode",)
IDLE = {"decode.prefill": 0.25, "decode.step": 1.0, "decode.sample": 0.5,
        "decode.refresh": 0.25, "gpt.forward": 2.0, "gpt.block": 0.5,
        "ops.gqa_decode": 0.125, "train.forward": 0.75,
        "train.backward": 0.0625, "train.clip": 0.0625,
        "train.optimizer": 0.125, "data.sample": 0.5,
        "Optimizer.step_AdamW.step": 4.0, "aten::copy_": 3.0,
        "port_bench.generate": 0.5}
WANT = {"loop_idle.decode": 20.0, "model_idle.decode": 25.0,
        "k1_idle.decode": 1.25, "model_idle.train": 25.0,
        "step_idle.train": 15.0}


def _record(window, summary=True):
    ts = (trace.TraceSummary(window_s=10.0, busy_s=2.0, device_ops={},
                             idle_by_host=dict(IDLE)) if summary else None)
    return Record(cell=None, run=None, window=window, trace=ts)


WINDOW = {"calls": 4, "steps": 3}


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_their_groups_idle(name):
    assert spec.load_reader(name)(_record(WINDOW)) == pytest.approx(
        WANT[name], rel=1e-12)


def test_weight_cast_reader_reads_bytes_a_forward(monkeypatch):
    from ai_music_generation_tpu_torch.models.gpt import GPT, cast_param

    monkeypatch.setattr(cast_param, "bytes", 57_507_840 * 7)
    monkeypatch.setattr(GPT.forward, "calls", 7)
    read = spec.load_reader("weight_cast_mb.decode")
    assert read(_record(WINDOW)) == pytest.approx(57.50784, rel=1e-12)
    monkeypatch.setattr(GPT.forward, "calls", 0)
    assert read(_record(WINDOW)) is None


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("window,summary", [
    (WINDOW, False), ({"calls": 0, "steps": 0}, True)],
    ids=["no_trace", "empty_window"])
def test_readers_read_none_without_a_window(name, window, summary):
    assert spec.load_reader(name)(_record(window, summary)) is None


# the parent of the spans: no tracing module, a model module without the
# counters
@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("gone", ["module", "names"])
def test_readers_read_none_without_the_programs_spans(monkeypatch, name,
                                                      gone):
    for mod in ("ai_music_generation_tpu_torch.utils.tracing",
                "ai_music_generation_tpu_torch.models.gpt"):
        monkeypatch.setitem(sys.modules, mod, None if gone == "module"
                            else types.ModuleType(mod))
    assert spec.load_reader(name)(_record(WINDOW)) is None


@pytest.mark.cuda
def test_traced_generate_labels_idle_gaps_with_program_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ai_music_generation_tpu_torch.decode.generate import Generator
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
    from ai_music_generation_tpu_torch.utils import tracing

    cfg = GPTConfig(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                    n_embd=384, n_kv_head=2, bias=False, kv_quantized=True,
                    flat_kv=True)
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    gen = Generator(model.cuda().eval(), max_new_tokens=48,
                    temperature=0.8, top_k=20, window=32, refresh=16)
    prompts = torch.randint(0, 128, (64, 8), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    plain = gen.generate(prompts, seed=3)
    torch.cuda.synchronize()
    traced, summary = trace.profile(lambda: gen.generate(prompts, seed=3))
    assert torch.equal(plain, traced)
    names = set(tracing.DECODE_LOOP + tracing.MODEL + tracing.K1)
    assert tracing.GPT_BLOCK in summary.idle_by_host
    assert not names & set(summary.device_ops)
    assert summary.busy_s > 0
