"""The model's own host time in training as a share of the traced window:
the device's idle seconds that began while a span of the program's model
(``utils/tracing.py`` ``MODEL``: ``gpt.forward``, ``gpt.block``) was the
innermost host operation open, over the window's length, in percent."""

from port_bench.harness import spans


def read(record):
    try:
        from ai_music_generation_tpu_torch.utils.tracing import MODEL
    except ImportError:  # a program that opens no spans
        return None
    return spans.idle_percent(record, MODEL, "steps")
