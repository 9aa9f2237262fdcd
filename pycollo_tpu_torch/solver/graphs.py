"""One piece of host code replayed as CUDA graphs, split at its eager calls.

:class:`Replay` runs ``fn(*args)`` (the solver's dense trip, on static
buffers that it updates in place) once while capturing the kernels it
launches, and replays them at every later run.  A call that a capture
cannot hold is marked by the code with :func:`eager`: a host read that
steers the code (the escalation loop, which asks whether any row
escalates), or a library call that allocates device memory (MAGMA's batched
``cholesky_solve`` in GMRES).  Such a call ends the graph being captured;
at every replay it runs again, between the graph before it and the graph
after it, on the tensors the first left, and its result is copied to where
the second reads it.  Replaying launches the kernels of ``fn`` in its
order, with its shapes and arguments, so it computes what ``fn`` computes,
bit for bit.

The first run captures each graph and launches it at once, then runs the
eager call for real, so it is itself a run of ``fn``.  On a card it starts
with a warm-up run of ``fn`` on copies of the arguments, on a side stream,
where the first use of each kernel, library handle and device constant
happens (a capture refuses them), and the cyclic garbage collector stays
off while it captures.  The graphs share one memory pool, which keeps the
captured tensors for the life of the :class:`Replay`.

The counts that ``fn`` makes inside a graph (``profiling.count``,
``profiling.bump``) are taped at the capture and made again by each
replay; those of eager calls are made as they run.  The spans of the code
inside a graph record at the capture only (under ``ipm.capture``), and
each replayed graph is a span ``ipm.replay``.

On the CPU, :class:`Replay` is its own stand-in, with the same buffers,
tapes and eager calls: the capture is a direct call of ``fn``, and a
replay calls ``fn`` again with the counts of its graph parts suppressed and
makes the tapes' counts instead.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch

from .. import profiling
from ..profiling import span


class _Local(threading.local):
    def __init__(self):
        #: the recording of this thread's first run of a Replay, or the
        #: CPU stand-in's replay (_STAND_IN), or None
        self.recording = None


_local = _Local()
#: recordings open in the process, and whether the cyclic garbage collector
#: was on when the first of them opened
_paused = [0, False]
_paused_lock = threading.Lock()
#: ``_local.recording`` while the CPU stand-in replays
_STAND_IN = object()


def eager(fn: Callable, *args):
    """``fn(*args)``, a call that the code around it asks to run eagerly at
    every replay (see the module's docstring); outside a :class:`Replay`,
    just the call."""
    rec = _local.recording
    if rec is None:
        return fn(*args)
    _local.recording = None     # an eager call inside it is just a call
    try:
        if rec is not _STAND_IN:
            return rec.eager(fn, args)
        outer = profiling.set_tape(None)
        try:
            return fn(*args)
        finally:
            profiling.set_tape(outer)
    finally:
        _local.recording = rec


@contextmanager
def _collector_paused():
    """No cyclic garbage collection while any recording is open, in any
    thread: a graph it frees would be destroyed inside a capture."""
    with _paused_lock:
        if _paused[0] == 0:
            _paused[1] = gc.isenabled()
            gc.disable()
        _paused[0] += 1
    try:
        yield
    finally:
        with _paused_lock:
            _paused[0] -= 1
            if _paused[0] == 0 and _paused[1]:
                gc.enable()


class _Graph:
    """A captured graph (None on the CPU) and the counts of its code."""

    def __init__(self, graph, tape: list):
        self.graph, self.tape = graph, tape

    def replay(self) -> None:
        with span("ipm.replay"):
            if self.graph is not None:
                self.graph.replay()
            profiling.replay(self.tape)


class _Eager:
    """An eager call: the function, its static arguments and its result
    (a tensor, where the graph after it reads, or None)."""

    def __init__(self, fn: Callable, args: tuple, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self) -> None:
        out = self.fn(*self.args)
        if self.out is not None:
            self.out.copy_(out)


class _Recording:
    """The first run of a :class:`Replay`: the pieces captured so far."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pieces: List[object] = []
        self.capturing = False
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.ambient = torch.cuda.current_stream(device)
            self.stream = torch.cuda.Stream(device)

    def begin(self) -> None:
        """Start capturing the next graph."""
        self.tape: list = []
        self.outer = profiling.set_tape(self.tape)
        self.graph = None
        if self.cuda:
            self.graph = torch.cuda.CUDAGraph()
            torch.cuda.set_stream(self.stream)
            self.capturing = True
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")

    def _stop(self) -> None:
        capturing, self.capturing = self.capturing, False
        try:
            if capturing:
                try:
                    self.graph.capture_end()
                finally:
                    torch.cuda.set_stream(self.ambient)
        finally:
            profiling.set_tape(self.outer)

    def end(self) -> None:
        """End the graph, and launch it."""
        self._stop()
        piece = _Graph(self.graph, self.tape)
        self.pieces.append(piece)
        piece.replay()

    def eager(self, fn: Callable, args: tuple):
        self.end()
        out = fn(*args)
        self.pieces.append(_Eager(fn, args, out))
        self.begin()
        return out

    def abort(self) -> None:
        """After an exception: end a capture in progress (its graph is
        lost), and give back the stream and the tape."""
        try:
            self._stop()
        except RuntimeError:
            pass      # a capture that the exception invalidated


class Replay:
    """``fn(*args)`` replayed as CUDA graphs split at its :func:`eager`
    calls (see the module's docstring).  ``args`` are static: ``fn`` reads
    and writes them in place, and every :meth:`run` runs it on them."""

    def __init__(self, fn: Callable, *args):
        self.fn, self.args = fn, args
        self.device = next(a.device for a in args if torch.is_tensor(a))
        self.pieces: Optional[List[object]] = None

    @property
    def graphs(self) -> int:
        return sum(isinstance(p, _Graph) for p in self.pieces or ())

    def run(self) -> bool:
        """One run of ``fn`` on the arguments; True when it captured."""
        if self.pieces is not None:
            self._replay()
            return False
        with span("ipm.capture"):
            if self.device.type == "cuda":
                self._warm_up()
                torch.cuda.synchronize(self.device)
                # Free what dead solvers hold (their graphs, in reference
                # cycles, would otherwise be destroyed by the collector in
                # the middle of a capture, which invalidates it) and what
                # the warm-up left cached, which the graphs' pool cannot use.
                gc.collect()
                torch.cuda.empty_cache()
            rec = _Recording(self.device)
            _local.recording = rec
            try:
                with _collector_paused():
                    rec.begin()
                    self.fn(*self.args)
                    rec.end()
            except BaseException:
                rec.abort()
                raise
            finally:
                _local.recording = None
        self.pieces = rec.pieces
        return True

    def _replay(self) -> None:
        if self.device.type == "cuda":
            for piece in self.pieces:
                piece.replay()
            return
        # the stand-in: the code again, its graph parts counting nothing
        _local.recording = _STAND_IN
        try:
            with profiling.taping():
                self.fn(*self.args)
        finally:
            _local.recording = None
        for piece in self.pieces:
            if isinstance(piece, _Graph):
                piece.replay()

    def _warm_up(self) -> None:
        """``fn`` on copies of the arguments, on a side stream, counting
        nothing."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), profiling.taping():
            self.fn(*_clone(self.args))
        torch.cuda.current_stream(self.device).wait_stream(side)


def _clone(x):
    """Copies of the tensors of a nest of tensors and tuples."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*map(_clone, x)) if hasattr(x, "_fields") \
            else tuple(map(_clone, x))
    return x

