"""What the readers of the program's own spans share: the idle time of the
traced window that a group of the program's spans holds.

Each reader imports its group (``DECODE_LOOP``, ``MODEL``, ``K1``,
``TRAIN_STEP``) from the program's ``utils/tracing.py``, so a span renamed
there is renamed in the reader; a program without that module or group
(one that opens no spans) reads None, not 0.
"""

from __future__ import annotations


def idle_percent(record, names, count: str):
    """100 x the device's idle seconds in the traced window that began
    while one of the spans ``names`` was the innermost host operation open
    (``trace.idle_by_host``), over the window's length. None without a
    trace or with a window of no ``count`` (its calls or steps)."""
    trace = record.trace
    if trace is None or trace.window_s <= 0 or not record.window.get(count):
        return None
    return 100.0 * sum(trace.idle_by_host.get(n, 0.0)
                       for n in names) / trace.window_s
