"""Reduce a profiler trace (Chrome trace JSON from ``torch.profiler``) to
what the per-layer metrics and the ``breakdown`` read.

The traced window runs from the start of the first request's span to the
end of the last request that completed inside the measured window, so the
device time and bytes of a request cut off by the window's end count as
little as its work does.  Device operations are the CUDA events (kernels,
memcpys, memsets); the busy time is the union of their intervals, clipped
to the window.  An idle gap is named after what the host was doing during
it: the innermost host event of the thread that issued the requests.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: float                 # summed durations of kernels
    h2d_bytes: int                  # bytes of host-to-device copies
    device_ops: list                # [[name, seconds]] top TOP
    idle_gaps: list                 # [[host activity, seconds]] top TOP
    spans: int                      # request spans in the window


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(events):
    """Host events of one thread -> [(start, end, name)] segments, each
    named after the innermost event open over it."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    segs, stack, cursor = [], [], None

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if cursor < end:
                segs.append((cursor, end, name))
            cursor = max(cursor, end)

    for start, end, name in events:
        if cursor is None:
            cursor = start
        close_until(start)
        if stack and cursor < start:
            segs.append((cursor, start, stack[-1][1]))
        cursor = max(cursor, start)
        if stack:  # a child ends with its parent (clock rounding)
            end = min(end, stack[-1][0])
        stack.append((end, name))
    if stack:
        close_until(float("inf"))
    return segs


def _attribute(gaps, segs):
    """Seconds of each gap spent under each segment's name."""
    by_name = defaultdict(float)
    j = 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < ge:
            s, e, name = segs[k]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                by_name[name] += ov
                covered += ov
            k += 1
        rest = (ge - gs) - covered
        if rest > 0:
            by_name["(host: outside any event)"] += rest
    return by_name


def summarize(path, span_prefix: str, n_done: int) -> Summary:
    """Reduce the trace at ``path``: the window is the first ``n_done``
    host spans whose names start with ``span_prefix``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(span_prefix)),
                   key=lambda e: e["ts"])
    if n_done < 1 or len(spans) < n_done:
        raise ValueError(f"the trace holds {len(spans)} request spans, "
                         f"expected at least {n_done}")
    w0 = float(spans[0]["ts"])
    w1 = float(spans[n_done - 1]["ts"]) + float(spans[n_done - 1]["dur"])
    main = (spans[0].get("pid"), spans[0].get("tid"))
    dev, host = [], []
    ops = defaultdict(float)
    kernel_us, h2d = 0.0, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            cs, ct = max(s, w0), min(t, w1)
            if ct <= cs:
                continue
            dev.append((cs, ct))
            ops[e["name"]] += (ct - cs) * 1e-6
            if cat == "kernel":
                kernel_us += ct - cs
            elif cat == "gpu_memcpy" and "HtoD" in e["name"] and s >= w0 \
                    and t <= w1:
                h2d += int(e.get("args", {}).get("bytes", 0))
        elif cat in HOST_CATS and (e.get("pid"), e.get("tid")) == main:
            if t > w0 and s < w1:
                host.append((s, t, e["name"]))
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    by_name = _attribute(gaps, _innermost(host))
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(((k, v * 1e-6) for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                   kernel_s=kernel_us * 1e-6, h2d_bytes=h2d,
                   device_ops=[[k, v] for k, v in top_ops],
                   idle_gaps=[[k, v] for k, v in top_gaps], spans=n_done)
