"""The share of the traced window in which no operation ran on the device
(the union of kernel, copy and set intervals, so overlapping streams count
once), in percent."""


def read(record):
    if record.trace is None or record.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)
