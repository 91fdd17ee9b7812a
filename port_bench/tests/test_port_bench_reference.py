"""The plain reference against the port's GPT on tiny configurations on the
CPU, computed in float32 on both sides: the forward pass, the windowed
int8-cache decode, and training steps with dropout, clipping and AdamW."""

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.train.optimizer import (
    cosine_warmup_schedule, make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import make_train_step
from port_bench.harness import program
from port_bench.reference import gpt_ref
from port_bench.reference.precision import Precision

torch.set_num_threads(2)


def tiny(kv_heads, bias):
    return {"n_layer": 2, "n_head": 4, "n_embd": 64, "n_kv_head": kv_heads,
            "block_size": 48, "vocab_size": 61, "bias": bias,
            "dtype": "float32", "param_dtype": "float32"}


@pytest.mark.parametrize("kv_heads,bias", [(None, True), (2, False)])
def test_forward_matches_the_port(kv_heads, bias):
    cfg = tiny(kv_heads, bias)
    model, w = program.build_gpt(cfg, 7, "cpu")
    idx = torch.randint(0, cfg["vocab_size"], (3, 40),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = model(idx, return_all_logits=True)[0]
    ref = gpt_ref.forward(w, cfg, idx, Precision("fp32"))
    torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [True, False])
def test_windowed_decode_matches_the_port(quantized):
    cfg = tiny(2, False)
    model, w = program.build_gpt(cfg, 11, "cpu", kv_quantized=quantized,
                                 flat_kv=True)
    gen = Generator(model, max_new_tokens=50, temperature=0.0, window=24)
    prompts = torch.randint(0, cfg["vocab_size"], (4, 5),
                            generator=torch.Generator().manual_seed(2))
    tokens = gen.generate(prompts).long()
    ref = gpt_ref.served_logits(w, cfg, tokens, 5, 24, gen.refresh,
                                Precision("fp32", 8 if quantized else None))
    gap = ref.amax(-1) - ref.gather(-1, tokens[:, 5:, None])[..., 0]
    assert float(gap.max()) < 1e-4


def test_training_steps_match_the_port(tmp_path):
    cfg = tiny(2, True)
    opt = {"dropout": 0.2, "learning_rate": 1e-3, "weight_decay": 0.1,
           "beta1": 0.9, "beta2": 0.99, "grad_clip": 0.5,
           "warmup_iters": 2, "lr_decay_iters": 50, "min_lr": 1e-4}
    model, w = program.build_gpt(cfg, 5, "cpu", dropout=opt["dropout"])
    w0 = {k: v.clone() for k, v in w.items()}
    optimizer = make_optimizer(model, opt["learning_rate"],
                               opt["weight_decay"], opt["beta1"], opt["beta2"])
    schedule = cosine_warmup_schedule(opt["learning_rate"],
                                      opt["warmup_iters"],
                                      opt["lr_decay_iters"], opt["min_lr"])
    step = make_train_step(model, optimizer, schedule, opt["grad_clip"])
    rng = np.random.default_rng(0)
    feed = [tuple(torch.from_numpy(rng.integers(0, 61, (2, 3, 48)))
                  for _ in "xy") for _ in range(3)]
    losses, grads = [], None
    for s, (x, y) in enumerate(feed):
        losses.append(float(step(x, y, s, 9)["loss"]))
        if s == 0:
            grads = {k: float(optimizer.state[p]["exp_avg"].norm())
                     / (1 - opt["beta1"])
                     for k, p in model.named_parameters()}
    ref = gpt_ref.train_three_steps(w0, dict(cfg, dropout=opt["dropout"]), opt,
                                    feed, schedule, 9, Precision("fp32"), 2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(grads[k], ref["grad_norms"][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        change = float((p.detach() - w0[k]).norm())
        np.testing.assert_allclose(change, ref["change_norms"][k], rtol=1e-3,
                                   atol=1e-8, err_msg=k)
