"""Spans and counters of the port's solves.

The program marks its stages with :func:`span` and counts its work with
:func:`count`.  What they do depends on who is looking:

- **Off** (the default: no ``torch.profiler`` running and no recording
  open), a span is one flag check that returns a shared no-op context, and
  a count returns at once: no ``record_function``, no device op, no host
  read of a device value, no allocation.
- **Under a running** ``torch.profiler``, a span opens a
  ``record_function`` range of its name, so the trace holds the stages on
  the clock of the device activity, and an idle gap on the device can be
  put down to the stage the host was in.
- **Inside** :func:`recording`, a span keeps the count, total and self host
  seconds (total less the time its child spans cover) of its *path*, the
  chain of open spans of its thread (``ipm.trip/ipm.line_search/ipm.gmres``),
  and counts add up in the :class:`Record`.  A count of a device tensor is
  summed on its device and read when the recording closes, so recording
  adds no host synchronisation inside a solve.

The stages of a batched solve, as they nest::

    batch.inputs                 host-to-device copies (parallel/batch.py)
    ipm.solve                    solver/ipm.py
      ipm.init                   init_state
      ipm.wait                   a host read of a device value
      ipm.trip                   one IPM loop trip; self: state, mu and
                                 filter updates, the loop's merge
        ipm.derivatives          gradients, residuals, Jacobian, KKT error
        ipm.step                 Newton step; self: Hessian, assembly,
                                 level selection, dual steps
          ipm.factor             an equilibrated factorization
            block_chol.blocked   the factorization of a matrix wider than
                                 one kernel launch, in blocks
          ipm.gmres              a KKT solve on the factors
          ipm.escalation         the loop above the speculative ladder
            ipm.wait, ipm.factor, ipm.gmres
          banded.*               the block-banded step's stages
        ipm.line_search          the filter or merit sweep
          ipm.gmres              the second-order corrector
        ipm.restoration          restoration acceptance and transitions
        ipm.wait
      ipm.certify                the returned iterate and its KKT error
    batch.outputs                assembly and device-to-host copies

On a card the dense trip is replayed as CUDA graphs (``solver/graphs.py``):
a trip's spans are ``ipm.replay`` (each graph), ``ipm.escalation`` and
``ipm.wait``, and the spans of the code inside the graphs
(``ipm.derivatives``, ``ipm.step``, ``ipm.line_search``, ...) record once,
inside ``ipm.capture``, when the graphs are captured.

Counters: ``ipm.trips``, ``ipm.syncs`` (host reads of device values),
``ipm.rows_computed`` (the batch, every trip), ``ipm.active_rows`` (the
rows still iterating, every trip), ``ipm.escalation_trips``,
``ipm.escalation_rows_factored`` (the batch, every escalation trip),
``ipm.escalation_rows`` (the rows that escalate, every escalation trip),
``ipm.graph_captures`` (graphs captured) and ``ipm.graph_replays`` (trips
run by replaying graphs).  The package's own counters live on its
functions and outside any recording: ``blocked_chol_linv.calls``,
``.blocks`` (diagonal blocks factored, one kernel launch each) and
``.products`` (batched matrix products of the block algebra) in
``ops/block_chol.py``, and ``chol_inv.launches``.  The counts of code
inside a graph are made at its capture on a tape (:func:`taping`), and
each replay makes them again (:func:`replay`), so a replayed trip counts
what an eager one counts.

:class:`Profiler` times a mesh iteration's set-up stages
(``transcription.py``) into its own ``spans``; its spans are spans of this
module too.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the no-op context every span returns when off
_OFF = nullcontext()
#: the open recording, or None, set under the lock
_record: Optional["Record"] = None
_record_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        #: this thread's open recorded spans: [path, start, child ns]
        self.stack: List[list] = []
        #: while this thread captures a graph: the counter updates its code
        #: makes, kept for each replay to make (:func:`taping`)
        self.tape: Optional[list] = None


_local = _Local()


@dataclass
class SpanStats:
    """One span path's count and host nanoseconds."""

    count: int = 0
    total_ns: int = 0
    self_ns: int = 0

    @property
    def total_s(self) -> float:
        return self.total_ns * 1e-9

    @property
    def self_s(self) -> float:
        return self.self_ns * 1e-9


class Record:
    """What spans and counts kept inside one :func:`recording`.

    ``spans`` maps a span path to its :class:`SpanStats`; ``counters`` maps
    a counter's name to its total.  Both are complete once the recording
    has closed."""

    def __init__(self):
        self.spans: Dict[str, SpanStats] = {}
        self.counters: Dict[str, int] = {}
        self._device: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def by_name(self) -> Dict[str, SpanStats]:
        """The stats of each span name, summed over every path it ends."""
        out: Dict[str, SpanStats] = {}
        for path, s in self.spans.items():
            o = out.setdefault(path.rsplit("/", 1)[-1], SpanStats())
            o.count += s.count
            o.total_ns += s.total_ns
            o.self_ns += s.self_ns
        return out

    def _add(self, name: str, n) -> None:
        with self._lock:
            if torch.is_tensor(n):
                key = (name, n.device)
                total = n.sum()
                prev = self._device.get(key)
                self._device[key] = total if prev is None else prev + total
            else:
                self.counters[name] = self.counters.get(name, 0) + int(n)

    def _close(self) -> None:
        for (name, _), total in self._device.items():
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self._device.clear()


class _Span:
    __slots__ = ("name", "_range", "_record", "_frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self._record = _record
        if self._record is not None:
            stack = _local.stack
            path = f"{stack[-1][0]}/{self.name}" if stack else self.name
            self._frame = [path, time.perf_counter_ns(), 0]
            stack.append(self._frame)
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            path, start, child = self._frame
            elapsed = time.perf_counter_ns() - start
            stack = _local.stack
            stack.pop()
            if stack:
                stack[-1][2] += elapsed
            rec = self._record
            with rec._lock:
                s = rec.spans.get(path)
                if s is None:
                    s = rec.spans[path] = SpanStats()
                s.count += 1
                s.total_ns += elapsed
                s.self_ns += elapsed - child
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context that marks one stage of the program (see the module's
    docstring for what it does when off, under ``torch.profiler`` and
    inside :func:`recording`)."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the open recording; nothing when
    none is open.  ``n`` is a number, or a device tensor whose sum is added
    on its device and read when the recording closes.  Inside
    :func:`taping` the count goes on the tape instead."""
    bump(_count, name, n)


def _count(name: str, n) -> None:
    rec = _record
    if rec is not None:
        rec._add(name, n)


def bump(update, *args) -> None:
    """Make the counter update ``update(*args)`` now, or, inside
    :func:`taping`, put it on this thread's tape (the package's counters
    that live outside a recording, such as
    ``ops.block_chol.blocked_chol_linv.calls``, are updated through this)."""
    tape = _local.tape
    if tape is None:
        update(*args)
    else:
        tape.append((update, args))


@contextmanager
def taping():
    """Keep the counter updates of this thread (:func:`count`,
    :func:`bump`) on a tape, which the context yields, instead of making
    them.  A graph's capture runs inside one, and each replay of the graph
    makes the tape's updates (:func:`replay`): the code inside the graph
    runs only at the capture."""
    tape: list = []
    outer = set_tape(tape)
    try:
        yield tape
    finally:
        set_tape(outer)


def set_tape(tape: Optional[list]) -> Optional[list]:
    """Make ``tape`` this thread's tape (None: make counts as they come);
    returns the tape it had."""
    outer, _local.tape = _local.tape, tape
    return outer


def replay(tape: list) -> None:
    """Make the counter updates that :func:`taping` kept on ``tape``."""
    for update, args in tape:
        bump(update, *args)


@contextmanager
def recording():
    """Record every span and count of the process, from every thread, while
    the context is open; yields the :class:`Record`, complete on exit.
    Recordings do not nest."""
    global _record
    rec = Record()
    with _record_lock:
        if _record is not None:
            raise RuntimeError("a recording is already open")
        _record = rec
    try:
        yield rec
    finally:
        _record = None
        rec._close()


@dataclass
class Span:
    """A :class:`Profiler` span: its name, seconds and count."""

    name: str
    duration: float = 0.0
    count: int = 0


class Profiler:
    """Accumulates named wall-clock spans (a mesh iteration's set-up
    stages); each is also a :func:`span` of its name."""

    def __init__(self):
        self.spans: Dict[str, Span] = {}

    @contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, duration: float):
        s = self.spans.setdefault(name, Span(name))
        s.duration += duration
        s.count += 1
