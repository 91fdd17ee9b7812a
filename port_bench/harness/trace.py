"""The traced run: the measured window under ``torch.profiler`` (CPU and
CUDA activities), reduced to what the per-layer readers and the result's
``breakdown`` need.

The window is the host span ``port_bench.window`` that the runner opens
around the whole window (it ends after a synchronize, so every operation
of the window ran inside it). Device operations (kernels, copies, sets)
are clipped to it; busy time is the union of their intervals, so
overlapping streams count once. Each idle interval of the device inside
the window is labelled with the host operation, on any thread, that was
open when it began and had started last.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "port_bench.window"
NAME_CHARS = 120


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # name -> (count, seconds) of every device operation in the window
    device_ops: dict
    # host label -> idle seconds of the device while the host was there
    idle_by_host: dict

    def kernel_count(self) -> int:
        return sum(n for name, (n, _) in self.device_ops.items()
                   if not name.startswith(("Memcpy", "Memset")))

    def seconds_of(self, substrings) -> tuple[int, float]:
        """(calls, seconds) of the device operations whose name holds any
        of ``substrings``."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.device_ops.items():
            if any(sub in name for sub in substrings):
                calls, secs = calls + n, secs + s
        return calls, secs

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], s] for n, (_, s) in ops[:top]],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps[:top]]}


def profile(fn):
    """Run ``fn()`` under the profiler inside the window span; return its
    result and the :class:`TraceSummary`."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, summarize(prof.profiler.kineto_results.events())


def summarize(events) -> TraceSummary:
    from torch.autograd import DeviceType

    window = [e for e in events if e.name() == WINDOW_SPAN
              and e.device_type() == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} window spans in the trace")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    dev_s, dev_e, dev_n = [], [], []
    host_s, host_e, host_n = [], [], []
    # a host span (record_function) shows on the device's timeline too, as
    # an annotation over the kernels it launched: not an operation
    spans = {e.name() for e in events if e.is_user_annotation()
             and e.device_type() == DeviceType.CPU}
    for e in events:
        if e.device_type() != DeviceType.CPU and (e.is_user_annotation()
                                                  or e.name() in spans):
            continue
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            # a kernel launch says less than the operation around it
            if (name != WINDOW_SPAN
                    and not (name.startswith("cuda") and not name.startswith(
                        ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaMemcpy")))):
                host_s.append(e.start_ns())
                host_e.append(e.end_ns())
                host_n.append(name)
        else:
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                dev_s.append(s)
                dev_e.append(t)
                dev_n.append(e.name())
    ops = defaultdict(lambda: [0, 0.0])
    for name, s, t in zip(dev_n, dev_s, dev_e):
        ops[name][0] += 1
        ops[name][1] += (t - s) * 1e-9
    idle_s, idle_e = _idle(np.array(dev_s, np.int64), np.array(dev_e, np.int64),
                           w0, w1)
    busy = (w1 - w0 - int((idle_e - idle_s).sum())) * 1e-9
    labels = _label(idle_s, np.array(host_s, np.int64),
                    np.array(host_e, np.int64), host_n)
    idle = defaultdict(float)
    for label, s, t in zip(labels, idle_s, idle_e):
        idle[label] += (t - s) * 1e-9
    return TraceSummary((w1 - w0) * 1e-9, busy,
                        {k: tuple(v) for k, v in ops.items()}, dict(idle))


def _idle(starts, ends, w0, w1):
    """The intervals of [w0, w1] that no [start, end) covers."""
    if len(starts) == 0:
        return np.array([w0]), np.array([w1])
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    reach = np.maximum.accumulate(ends)
    # a gap opens after interval i when the next starts past all before
    gap = starts[1:] > reach[:-1]
    gs = np.concatenate([[w0], reach[:-1][gap], [reach[-1]]])
    ge = np.concatenate([[starts[0]], starts[1:][gap], [w1]])
    keep = ge > gs
    return gs[keep], ge[keep]


def _label(at, host_s, host_e, host_n) -> list:
    """The host operation open at each time of ``at`` that started last,
    over every host thread (the backward pass runs on autograd's own
    thread while the main one waits in ``backward``): a sweep over the
    operations in start order with a heap of the open ones."""
    order = np.argsort(host_s, kind="stable")
    labels = ["(no host operation)"] * len(at)
    heap, j = [], 0
    for q in np.argsort(at, kind="stable"):
        t = at[q]
        while j < len(order) and host_s[order[j]] <= t:
            i = order[j]
            heapq.heappush(heap, (-host_s[i], host_e[i], i))
            j += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        if heap:
            labels[q] = host_n[heap[0][2]]
    return labels
