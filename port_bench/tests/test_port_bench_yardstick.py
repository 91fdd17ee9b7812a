"""The benchmark's counts of bytes, calls and operations."""

import pytest

from port_bench.harness import yardstick
from port_bench.reference import gpt_ref

MUSIC = {"n_layer": 6, "n_head": 6, "n_embd": 384, "n_kv_head": 2,
         "block_size": 256, "vocab_size": 128, "bias": False}
GPT2 = {"n_layer": 12, "n_head": 12, "n_embd": 768, "n_kv_head": None,
        "block_size": 1024, "vocab_size": 50257, "bias": True}


def test_k1_bytes_match_the_kernel_table():
    # PERF.md's K1 row: B=4096, S=128, KH=2, D=64, int8, pos 127: 146.8 MB
    assert yardstick.k1_bytes(4096, MUSIC, 127, True) == 146_800_640
    # the GPT-2 step: B=256, S=1024, bf16, pos 1023: 807 MB
    assert round(yardstick.k1_bytes(256, GPT2, 1023, False) / 1e6) == 807


@pytest.mark.parametrize("prompt,new,window", [(8, 500, 128), (8, 500, 1024),
                                               (5, 60, 32), (3, 10, 64)])
def test_one_step_a_generated_token(prompt, new, window):
    calls = yardstick.decode_calls(prompt, new, window, window // 2)
    steps = [pos for kind, pos in calls if kind == "step"]
    first = yardstick.prefill_len(prompt, window)
    assert len(steps) == prompt + new - first
    assert all(0 <= pos < window for pos in steps)
    # the reference's contexts cover exactly the generated tokens
    spans = gpt_ref.decode_contexts(prompt, prompt + new, window, window // 2)
    assert sum(hi - lo for _, lo, hi in spans) == new
    assert all(hi - 1 - start <= window for start, lo, hi in spans)


def test_decode_flops_of_a_step():
    calls = [("step", 127)]
    n = yardstick.matmul_params(MUSIC)
    assert n == 6 * (384 * 640 + 384 * 384 + 8 * 384 * 384) + 128 * 384
    assert yardstick.decode_flops(MUSIC, calls) == 2 * n + 4 * 6 * 6 * 64 * 128


def test_train_flops_follow_estimate_mfu():
    assert yardstick.train_flops_per_token(GPT2, 100, 1024) == (
        600 + 12 * 12 * 12 * 64 * 1024)
