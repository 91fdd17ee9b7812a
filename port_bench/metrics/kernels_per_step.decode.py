"""Device kernels a decode step: the kernels the profiler saw in the traced
window over the tokens the window's generates fed (one T=1 step of every
layer is one step; the encodes' kernels count too). Memory copies and sets
are not kernels."""


def read(record):
    if record.trace is None or record.window.get("calls", 0) == 0:
        return None
    steps = record.window["calls"] * record.run.new
    return record.trace.kernel_count() / steps
