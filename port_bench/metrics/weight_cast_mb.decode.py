"""The per-use weight casts of a decode forward, in MB: the bytes the
program's parameter casts to the compute dtype read and write
(``models/gpt.py::cast_param.bytes``: numel x (source + target bytes) a
cast) over the forwards (``GPT.forward.calls``). Both count only while a
profiler records, so over the traced window. None where the program has no
such counters."""


def read(record):
    if record.trace is None or not record.window.get("calls"):
        return None
    try:
        from ai_music_generation_tpu_torch.models.gpt import GPT, cast_param
        cast, calls = cast_param.bytes, GPT.forward.calls
    except ImportError:
        return None
    return cast / calls / 1e6 if calls else None
