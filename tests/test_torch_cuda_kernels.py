"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import dataclasses

import pytest
import torch

from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, KVCache
from ai_music_generation_tpu_torch.ops.gqa_decode import (
    gqa_decode_reference,
    gqa_decode_update,
)

torch.set_num_threads(1)

H, KH, D = 6, 2, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(quant, ring, pos, B, S, seed=0):
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
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gqa_decode_kernel_matches_twin(cuda, quant, ring):
    for B, S in ((8, 32), (3, 77), (64, 128)):
        for pos in (0, 5, 8, S - 1):
            cpu = _inputs(quant, ring, pos, B, S)
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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(kv_quantized=True, n_kv_head=2),
    dict(kv_quantized=False, n_kv_head=2),
    dict(kv_quantized=True, n_kv_head=None),
    dict(kv_quantized=False, n_kv_head=None),
], ids=["int8-kh2", "bf16-kh2", "int8-mha", "bf16-mha"])
def test_model_decode_on_cuda_matches_cpu(cuda, variant):
    """Prefill + 12 teacher-forced decode steps of a 2-layer model at the
    bench widths: bf16 logits on the card within 2^-4 of their range of the
    CPU's (8 bf16 ulps at the largest logit), and one kernel launch per
    layer per step."""
    cfg = GPTConfig(block_size=64, vocab_size=128, n_layer=2, n_head=6,
                    n_embd=384, bias=False, **variant)
    cpu_model = init_weights(GPT(cfg), torch.Generator().manual_seed(0))
    gpu_model = GPT(dataclasses.replace(cfg)).to(cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(0, 128, (16, 20), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    caches = KVCache.create(cfg, 16, device=cuda), KVCache.create(cfg, 16)
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
