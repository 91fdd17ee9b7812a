"""The decode's share of the chip's dense bf16 peak: the operations the
window's generates need, counted from the shapes
(``yardstick.decode_flops``: 2N a fed token plus 4 L H D a live column; the
encodes causal, the head on their last token), over the traced window's
length, against 989 TFLOP/s (NVIDIA H100 SXM, 700 W), in percent."""

from port_bench.harness import yardstick


def read(record):
    if record.trace is None or record.window.get("calls", 0) == 0:
        return None
    run = record.run
    flops = (yardstick.decode_flops(run.model_cfg, run.calls_per_generate())
             * run.B * record.window["calls"])
    return 100.0 * flops / record.trace.window_s / yardstick.PEAK_BF16_FLOPS
