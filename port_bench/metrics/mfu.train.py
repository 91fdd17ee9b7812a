"""The training step's share of the chip's dense bf16 peak: nanoGPT's
``estimate_mfu`` count (6N + 12 L H D T a token, N the parameters but the
position table) times the tokens of the window's steps, over the traced
window's length, against 989 TFLOP/s (NVIDIA H100 SXM, 700 W), in
percent."""

import math

from port_bench.harness import weights, yardstick


def read(record):
    if record.trace is None or record.window.get("steps", 0) == 0:
        return None
    run = record.run
    cfg = run.model_cfg
    n = sum(math.prod(shape) for name, shape, _ in weights.leaves(cfg)
            if name != "transformer.wpe.weight")
    flops = (yardstick.train_flops_per_token(cfg, n, run.block)
             * run.tokens_per_step() * record.window["steps"])
    return 100.0 * flops / record.trace.window_s / yardstick.PEAK_BF16_FLOPS
