"""K1's wrapper's host time as a share of the traced window: the device's
idle seconds that began while the span of K1's wrapper (``utils/tracing.py``
``K1``: ``ops.gqa_decode``: its checks, pointers and launch) was the
innermost host operation open, over the window's length, in percent."""

from port_bench.harness import spans


def read(record):
    try:
        from ai_music_generation_tpu_torch.utils.tracing import K1
    except ImportError:  # a program that opens no spans
        return None
    return spans.idle_percent(record, K1, "calls")
