"""The train step's own host time as a share of the traced window: the
device's idle seconds that began while a span of the program's train step
(``utils/tracing.py`` ``TRAIN_STEP``: ``train.forward``, ``train.backward``,
``train.clip``, ``train.optimizer``, ``data.sample``) was the innermost host
operation open, over the window's length, in percent. Torch's own spans
inside them (``Optimizer.step_AdamW.step``, the autograd engine's) keep
their labels."""

from port_bench.harness import spans


def read(record):
    try:
        from ai_music_generation_tpu_torch.utils.tracing import TRAIN_STEP
    except ImportError:  # a program that opens no spans
        return None
    return spans.idle_percent(record, TRAIN_STEP, "steps")
