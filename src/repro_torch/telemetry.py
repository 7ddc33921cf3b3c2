"""Spans of the program's own layers, recorded while a torch profiler records.

A span marks one stretch of work at a layer boundary: the serving engine's
panel stages, a solver iteration, a filter apply and the ``bsr`` backend's
stages inside it, the streaming lane's host algorithms. ``SPAN_NAMES``
lists every name the program emits.

There is no switch of its own. A span is on exactly while a
``torch.profiler`` session records (``torch.autograd.profiler``'s
``_is_profiler_enabled``) and the current stream is not being captured
into a CUDA graph. Off, ``span`` returns one shared object that does
nothing: one flag read, no ``record_function``, no clock read. On, it
enters ``torch.profiler.record_function(name)``, so the range shows in the
profiler's trace and in its ``export_chrome_trace``, and inside that range
reads ``time.time_ns()`` at entry and before exit (the profiler's own
clock, to a few microseconds) into a ``Record``: name, start, end, the
enclosing record, attributes and the recording thread. ``device=True``
also records a CUDA timing event on the current stream at entry and at
exit, for a span that enqueues device work without waiting for it; the
device time is read only when ``Record.device_ms`` is called, after the
work::

    with telemetry.span("serve.pack") as sp:
        if sp:  # false when off: attributes cost nothing then
            sp.note(b=b, k=k)
        ...

Records are grouped by profiler session: a span that finds the profiler
on, after an earlier span found it off, opens a new session.
``sessions()`` returns them, oldest first, each capped at ``MAX_RECORDS``
records (it counts what it drops). Nothing is written to a file: the
profiler's trace is the export.
"""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_RECORDS", "SPAN_NAMES", "Record", "Session", "clear", "sessions", "span"]

MAX_RECORDS = 200_000

SPAN_NAMES = {
    "serve.panel": "AsyncGraphFilterEngine: one panel, from its start to its tickets resolved "
                   "(lane, k, the tickets' tids and queue waits: panel start - submit)",
    "serve.pack": "stacking the requests' (N,) payloads into a bucket-wide zero-padded panel",
    "serve.upload": "the packed panel to the device through pinned memory (bytes)",
    "serve.replay": "the bucket's program on the uploaded panel (static-input copy and replay)",
    "serve.capture": "a program cache miss: the program's build and first call (lane, b)",
    "serve.copy_back": "the answers' blocking copy to the host and their split per request",
    "serve.resolve": "resolving the panel's tickets and releasing their admission slots",
    "serve.frame": "one frame's StreamingFilter.push on the frame lane (tid, stream, mode)",
    "stream.walk_delta": "the streaming lane's reach BFS and words walk over the changed set",
    "stream.apply_topology": "a topology delta: in-place patch, lmax certificate, plan repair",
    "filter.apply": "GraphFilter.apply (backend, shape; device events)",
    "filter.adjoint": "GraphFilter.adjoint (backend, shape; device events)",
    "bsr.permute": "BsrBackend: the signal gathered into the RCB order and padded",
    "bsr.tiling": "BsrBackend: select_tiling's choice of fused kernel and f_tile",
    "bsr.union": "BsrBackend: the union apply's launch (fused kernel or stepwise chain)",
    "bsr.recurrence": "BsrBackend: the adjoint (fused kernel or plain Block-ELL recurrence)",
    "bsr.unpermute": "BsrBackend: the output gathered back to the vertex order",
    "solver.iteration": "one step of a solver loop (method, index; device events)",
}


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``),
    the enclosing ``parent`` record (None at the top), ``attrs`` and the
    recording ``thread``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "thread", "events")

    def __init__(self, name: str, attrs: dict):
        self.name, self.parent, self.attrs = name, None, attrs
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's entry and exit events
        (waits for the exit event); None for a span without events."""
        if self.events is None:
            return None
        start, stop = self.events
        stop.synchronize()
        return start.elapsed_time(stop)

    def __repr__(self) -> str:
        return f"Record({self.name!r}, {self.host_ms:.3f} ms, {self.attrs})"


class Session:
    """The records of one profiler session, in the order their spans
    opened, and how many were ``dropped`` past ``MAX_RECORDS``."""

    __slots__ = ("records", "dropped")

    def __init__(self):
        self.records: list[Record] = []
        self.dropped = 0

    def named(self, name: str) -> list[Record]:
        return [r for r in self.records if r.name == name]


class _Off:
    """The shared span that does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


OFF = _Off()


class _On:
    __slots__ = ("recorder", "record", "device", "_range")

    def __init__(self, recorder: _Recorder, record: Record, device: bool):
        self.recorder, self.record, self.device = recorder, record, device

    def __bool__(self) -> bool:
        return True

    def note(self, **attrs) -> None:
        self.record.attrs.update(attrs)

    def __enter__(self):
        self._range = torch.profiler.record_function(self.record.name)
        self._range.__enter__()
        # The clock first: the profiler's range began just before it.
        self.record.start_ns = time.time_ns()
        stack = self.recorder.stack()
        self.record.parent = stack[-1] if stack else None
        stack.append(self.record)
        if self.device:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.record.events = (start, torch.cuda.Event(enable_timing=True))
        return self

    def __exit__(self, *exc) -> bool:
        if self.record.events is not None:
            self.record.events[1].record()
        self.recorder.stack().pop()
        self.record.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        return False


class _Recorder:
    def __init__(self):
        self.sessions: list[Session] = []
        self.off_seen = True
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list[Record]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open(self, name: str, device: bool, attrs: dict):
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            return OFF
        with self._lock:
            if self.off_seen:
                self.sessions.append(Session())
                self.off_seen = False
            session = self.sessions[-1]
        if len(session.records) >= MAX_RECORDS:
            session.dropped += 1
            return OFF
        record = Record(name, attrs)
        session.records.append(record)
        return _On(self, record, device and torch.cuda.is_initialized())


_RECORDER = _Recorder()


def span(name: str, *, device: bool = False, **attrs):
    """A context manager marking ``name`` (one of ``SPAN_NAMES``) while a
    profiler records; the shared no-op ``OFF`` otherwise. Both are truthy
    only when on, and take further attributes with ``note``."""
    if not _profiler._is_profiler_enabled:
        _RECORDER.off_seen = True
        return OFF
    return _RECORDER.open(name, device, attrs)


def sessions() -> list[Session]:
    """The recorded sessions, oldest first."""
    return list(_RECORDER.sessions)


def clear() -> None:
    """Forget every session (the next span that finds the profiler on
    opens a new one)."""
    with _RECORDER._lock:
        _RECORDER.sessions.clear()
        _RECORDER.off_seen = True
