"""Lightweight span timers and solve reports.

Capability parity with the reference's per-stage wall-clock timing
(``pycollo/iteration.py:139-194,352-358,377-384,499-503`` ``_time_*``
attributes and the summary at
``pycollo/optimal_control_problem.py:510-546``), upgraded to a reusable
span-timer utility: stages record wall-clock durations, nest, and render
a summary table.  Device-side profiling is left to ``torch.profiler``
(which these spans complement, not replace).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .utils import format_time


@dataclass
class Span:
    name: str
    duration: float = 0.0
    count: int = 0


class Profiler:
    """Accumulates named wall-clock spans."""

    def __init__(self):
        self.spans: Dict[str, Span] = {}
        self._order: List[str] = []

    @contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.add(name, elapsed)

    def add(self, name: str, duration: float):
        if name not in self.spans:
            self.spans[name] = Span(name)
            self._order.append(name)
        s = self.spans[name]
        s.duration += duration
        s.count += 1

    def total(self) -> float:
        return sum(s.duration for s in self.spans.values())

    def report(self) -> str:
        lines = ["Timing summary:"]
        width = max((len(n) for n in self._order), default=10)
        for name in self._order:
            s = self.spans[name]
            lines.append(f"  {name:<{width}}  {format_time(s.duration):>12}"
                         f"  (x{s.count})")
        lines.append(f"  {'total':<{width}}  "
                     f"{format_time(self.total()):>12}")
        return "\n".join(lines)
