"""The decode loop's own host time as a share of the traced window: the
device's idle seconds that began while a span of the program's decode loop
(``utils/tracing.py`` ``DECODE_LOOP``: ``decode.prefill``, ``decode.step``,
``decode.sample``, ``decode.refresh``) was the innermost host operation
open, over the window's length, in percent. Idle time that begins inside
an ATen operation keeps the operation's label; ``idle_share.decode`` is the
whole."""

from port_bench.harness import spans


def read(record):
    try:
        from ai_music_generation_tpu_torch.utils.tracing import DECODE_LOOP
    except ImportError:  # a program that opens no spans
        return None
    return spans.idle_percent(record, DECODE_LOOP, "calls")
