"""Reduction of a ``torch.profiler`` trace of one traced call.

:func:`reduce` takes the profiler's events (``Event`` tuples, read from
its Chrome trace by :func:`events_of`) and the name of the harness's range
around the call, and returns the numbers the per-layer readers and the
result line's ``breakdown`` need:

- ``window_s``: the length of the range;
- ``busy_s``: the time in the range in which some device operation
  (kernel, copy or fill) ran: the union of their intervals;
- ``kernels``: each kernel's (name, seconds, grid) in the range;
- ``device_ops``: device seconds by operation name, largest first;
- ``idle_gaps``: idle device seconds in the range by what the host was
  doing when each gap began: the innermost host event of the range's
  thread that covers the gap's start.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterable, List, NamedTuple, Optional, Tuple

#: trace categories of operations that occupy the device
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of host events that can name what the host did
HOST_EVENTS = ("cpu_op", "user_annotation")


class Event(NamedTuple):
    name: str
    kind: str          # the trace's category
    start_ns: int
    end_ns: int
    tid: int
    grid: Optional[Tuple[int, int, int]]


def events_of(prof, path) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``, read back from
    its Chrome trace, written to ``path`` and deleted again: only that
    export carries each kernel's grid."""
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as fh:
            raw = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    out = []
    for e in raw:
        kind = e.get("cat")
        if e.get("ph") != "X" or (kind not in DEVICE_OPS
                                  and kind not in HOST_EVENTS):
            continue
        start = int(round(float(e["ts"]) * 1e3))
        grid = e.get("args", {}).get("grid") if kind == "kernel" else None
        out.append(Event(e["name"], kind, start,
                         start + int(round(float(e.get("dur", 0)) * 1e3)),
                         e.get("tid"),
                         tuple(int(v) for v in grid) if grid else None))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_labels(host: List[Event], times: List[int]) -> List[str]:
    """The innermost host event covering each of the sorted ``times``
    (host events of one thread nest), or "host code" where none does."""
    host = sorted(host, key=lambda e: (e.start_ns, -e.end_ns))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start_ns <= t:
            while stack and stack[-1].end_ns <= host[i].start_ns:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "host code")
    return out


def reduce(events: List[Event], range_name: str, top: int = 10) -> dict:
    ranges = [e for e in events
              if e.kind == "user_annotation" and e.name == range_name]
    if not ranges:
        raise ValueError(f"no {range_name!r} range in the trace")
    rng = max(ranges, key=lambda e: e.end_ns - e.start_ns)
    t0, t1 = rng.start_ns, rng.end_ns
    dev = [e for e in events if e.kind in DEVICE_OPS
           and e.end_ns > t0 and e.start_ns < t1]
    busy = _union((max(e.start_ns, t0), min(e.end_ns, t1)) for e in dev)
    by_name = defaultdict(int)
    for e in dev:
        by_name[e.name] += min(e.end_ns, t1) - max(e.start_ns, t0)
    gaps, last = [], t0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if last < t1:
        gaps.append((last, t1))
    host = [e for e in events if e.kind in HOST_EVENTS and e.tid == rng.tid
            and e.end_ns > t0 and e.start_ns < t1]
    labels = _host_labels(host, [a for a, _ in gaps])
    idle = defaultdict(int)
    for (a, b), name in zip(gaps, labels):
        idle[name] += b - a
    kernels = [(e.name, (e.end_ns - e.start_ns) * 1e-9, e.grid)
               for e in dev if e.kind == "kernel"]

    def ranked(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(window_s=(t1 - t0) * 1e-9,
                busy_s=sum(b - a for a, b in busy) * 1e-9,
                kernels=kernels, device_ops=ranked(by_name),
                idle_gaps=ranked(idle))
