"""Program spans on the profiler's clock.

:func:`span` opens a profiler span while a ``torch.profiler.profile`` is
recording, and is a shared no-op context otherwise: a span costs a flag
read when nobody traces (an ungated ``record_function`` costs more than a
small ATen op). The span is torch's ``_RecordFunctionFast``, the C++
``RecordFunction`` that ``record_function`` wraps without its Python op
call: a sixth of its cost under the profiler, which a decode step pays for
each of its spans. The profiler keeps the spans in memory with its own
events and on the same clock as the device's activities, so a trace labels
each idle gap of the card with the innermost span open on the host when it
began. This module keeps no clock, buffer or exporter of its own.

The span names are the constants below, grouped by the layer that opens
them; the benchmark's readers (``port_bench/metrics/``) import the groups,
so a renamed span renames what they read.

A span in a region captured into a CUDA graph records only at capture,
never at replay: keep spans outside captured regions.
"""

from __future__ import annotations

import contextlib

import torch

# the decode loop (decode/generate.py)
DECODE_PREFILL = "decode.prefill"  # the first cache and encode
DECODE_STEP = "decode.step"  # one T=1 step: sample, commit, model call
DECODE_SAMPLE = "decode.sample"  # sample_logits: filter and draw
DECODE_REFRESH = "decode.refresh"  # a fresh cache and the re-prefill
# the model (models/gpt.py)
GPT_FORWARD = "gpt.forward"
GPT_BLOCK = "gpt.block"
# K1's wrapper (ops/gqa_decode.py): checks, pointers, launch; the CPU twin
K1_UPDATE = "ops.gqa_decode"
# the train step (train/step.py) and its batch draw (data/memmap.py)
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_CLIP = "train.clip"  # the gradients' scale, norm and clip
TRAIN_OPTIMIZER = "train.optimizer"  # the lr, optimizer.step, zero_grad
DATA_SAMPLE = "data.sample"

DECODE_LOOP = (DECODE_PREFILL, DECODE_STEP, DECODE_SAMPLE, DECODE_REFRESH)
MODEL = (GPT_FORWARD, GPT_BLOCK)
K1 = (K1_UPDATE,)
TRAIN_STEP = (TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_CLIP, TRAIN_OPTIMIZER,
              DATA_SAMPLE)

_OFF = contextlib.nullcontext()

# whether a profiler records: the one flag that spans and the program's
# counters (``models/gpt.py::cast_param``) read, so they cost nothing more
# than this read when nobody traces
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: the profiler's span ``name`` while a profiler
    records, else one shared no-op context."""
    if recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
