"""The traced run's device trace: `torch.profiler` over the window's
first `harness.TRACE_S` seconds, written as a chrome trace under
`TMPDIR`, read back into busy time, device time by operation and the
idle gaps, then deleted.

Device events are the trace's kernels, copies and sets. The window is
the `portbench.window` annotation the harness opens and closes around
that span; device time outside it is cut off. An idle gap is
named by the innermost host operation running at its middle, or
`host: python` where no operation was.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Capture:
    """Starts the profiler before the window and stops it after;
    `summary()` reads what it saw."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.mark = None

    def open(self) -> None:
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()

    def close(self) -> None:
        self.mark.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce(events)


def _spans(events, cats):
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            t = float(e["ts"])
            out.append((t, t + float(e.get("dur", 0.0)), e.get("name", "")))
    return out


def reduce(events: list) -> dict:
    """`{window_s, busy_s, device_s, by_name {name: (seconds, count)},
    gaps [(label, seconds)]}` of one chrome trace's events (times in
    microseconds in the trace, seconds here)."""
    host = _spans(events, HOST_CATS)
    marks = [s for s in host if s[2] == WINDOW]
    dev = sorted(_spans(events, DEVICE_CATS))
    if marks:
        w0, w1 = marks[0][0], marks[0][1]
    elif dev:
        w0, w1 = dev[0][0], dev[-1][1]
    else:
        return {"window_s": 0.0, "busy_s": 0.0, "device_s": 0.0,
                "by_name": {}, "gaps": []}
    by_name: dict[str, list] = {}
    device_us = 0.0
    merged: list[list[float]] = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        device_us += b - a
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (b - a) * 1e-6
        acc[1] += 1
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    holes = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                    for i in range(0, len(edges), 2)
                    if edges[i + 1] > edges[i]), reverse=True)[:10]
    ops = [s for s in host if s[2] != WINDOW]
    gaps = []
    for length, a, b in holes:
        mid = (a + b) / 2
        inner = [s for s in ops if s[0] <= mid <= s[1]]
        label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                 else "python")
        gaps.append((f"host: {label}", length * 1e-6))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "device_s": device_us * 1e-6,
            "by_name": {k: (v[0], v[1]) for k, v in by_name.items()},
            "gaps": gaps}


def kernel_time(summary: dict, patterns) -> tuple[float, int]:
    """Seconds and launches of the device operations whose name holds
    one of `patterns`."""
    s, n = 0.0, 0
    for name, (sec, count) in summary["by_name"].items():
        if any(p in name for p in patterns):
            s += sec
            n += count
    return s, n
