"""K1's share of its roofline over the traced window, in percent: the sum
of each call's bound (``yardstick.k1_bytes`` over 3.35 TB/s: the live
columns, their scales, q, the fresh K/V and the output, each moved once)
over the device time of the kernels named below. The calls are those of
the window's generates: one a layer a step, at the step's cache column."""

from port_bench.harness import yardstick

# the decode attention kernels of ops/csrc/gqa_decode.cuh (G > 1) and
# ops/csrc/gqa_decode_mha.cuh (G = 1)
KERNELS = ("gqa_decode_kernel", "gqa_decode_mha_kernel")


def read(record):
    if record.trace is None or record.window.get("calls", 0) == 0:
        return None
    calls, seconds = record.trace.seconds_of(KERNELS)
    if calls == 0 or seconds <= 0:
        return None
    run = record.run
    per_generate = sum(
        yardstick.k1_bytes(run.B, run.model_cfg, pos, run.quantized,
                           run.model_cfg["dtype"])
        for kind, pos in run.calls_per_generate() if kind == "step")
    bound = (per_generate * run.model_cfg["n_layer"] * record.window["calls"]
             / yardstick.HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
