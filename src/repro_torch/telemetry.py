"""Spans of the program's own layers, recorded while a torch profiler records.

A span marks one stretch of work at a layer boundary: the serving engine's
panel stages, a solver iteration, a filter apply and the ``bsr`` backend's
stages inside it, the streaming lane's host algorithms. ``SPAN_NAMES``
lists every name the program emits.

There is no switch of its own. A span is on exactly while a
``torch.profiler`` session records (``torch.autograd.profiler``'s
``_is_profiler_enabled``) and the current stream is not being captured
into a CUDA graph (for spans inside a graph, see ``capture_records``
below). Off, ``span`` returns one shared object that does
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

A counter (``count(name, value)``, one of ``COUNTER_NAMES``) is a record
of no duration whose ``attrs["value"]`` is a number or a device tensor,
read after the work; it is recorded under the same rule as a span, and its
``parent`` is the span open around it. Code that has to compute a value
asks ``on()`` first::

    if telemetry.on():
        telemetry.count("moe.expert_tokens", torch.bincount(idx, minlength=e))

A CUDA graph replays no Python, so spans and counters inside one are
recorded once, at its capture, under ``capture_records()``: there they are
on whatever the profiler does, a device span's timing events are
``external`` events that the graph records on every replay, and a counter's
value is a tensor the graph rewrites. The ``GraphRecords`` it returns adds
a copy of them to the session after each replay (``emit``, while a profiler
records), with that replay's device times and values; a replayed span has
no host time of its own::

    with telemetry.capture_records() as records, torch.cuda.graph(graph):
        out = step(x)
    ...
    with telemetry.span("lm.decode_step", device=True) as sp:
        graph.replay()
    records.emit(sp)

Records are grouped by profiler session: a span that finds the profiler
on, after an earlier span found it off, opens a new session.
``sessions()`` returns them, oldest first, each capped at ``MAX_RECORDS``
records (it counts what it drops). Nothing is written to a file: the
profiler's trace is the export.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_RECORDS", "SPAN_NAMES", "COUNTER_NAMES", "GraphRecords", "Record", "Session",
           "capture_records", "clear", "count", "on", "sessions", "span"]

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
    "lm.session_prefill": "ServeEngine: one session's document prefilled into the batch's cache "
                          "(rows, tokens; device events)",
    "lm.extend": "ServeEngine: every session extended through its cache by a turn's question "
                 "(rows, tokens; device events)",
    "lm.decode_step": "ServeEngine: one greedy decode step of the sessions' answers "
                      "(rows, position; device events)",
    "mla.attend": "latent attention's softmax and weighted sum (mode expanded or absorbed, "
                  "rows, keys; device events)",
    "moe.route": "the MoE router: scores, top-k and gates (tokens)",
    "moe.experts": "the MoE dispatch, the experts' FFNs, the combine and the shared experts "
                   "(tokens)",
}

COUNTER_NAMES = {
    "moe.expert_tokens": "tokens routed to each expert in one MoE call (an (E,) tensor)",
    "moe.dropped_tokens": "(token, slot) pairs one MoE call left without their expert's "
                          "output: past a capacity, or outside the rows a dropless dispatch "
                          "computed",
    "lm.latent_cache_bytes": "bytes of the latent cache the serving sessions hold",
}


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``),
    the enclosing ``parent`` record (None at the top), ``attrs`` and the
    recording ``thread``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "thread", "events",
                 "replayed_ms")

    def __init__(self, name: str, attrs: dict):
        self.name, self.parent, self.attrs = name, None, attrs
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.events = None
        self.replayed_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's entry and exit events
        (waits for the exit event); a replayed span's, read at its ``emit``;
        None for a span without events."""
        if self.events is None:
            return self.replayed_ms
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

    def _session(self) -> Session | None:
        """The session a record goes into (a new one after the profiler was
        seen off), or None while the stream captures a CUDA graph."""
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            return None
        with self._lock:
            if self.off_seen:
                self.sessions.append(Session())
                self.off_seen = False
            session = self.sessions[-1]
        if len(session.records) >= MAX_RECORDS:
            session.dropped += 1
            return None
        return session

    def open(self, name: str, device: bool, attrs: dict):
        session = self._session()
        if session is None:
            return OFF
        record = Record(name, attrs)
        session.records.append(record)
        return _On(self, record, device and torch.cuda.is_initialized())

    def count(self, name: str, value) -> None:
        session = self._session()
        if session is None:
            return
        record = Record(name, {"value": value})
        stack = self.stack()
        record.parent = stack[-1] if stack else None
        record.start_ns = record.end_ns = time.time_ns()
        session.records.append(record)

    def adopt(self, record: Record) -> None:
        session = self._session()
        if session is not None:
            session.records.append(record)


_RECORDER = _Recorder()


class _Captured:
    """A span met while a graph is captured under ``capture_records``."""

    __slots__ = ("graph", "record")

    def __init__(self, graph: GraphRecords, record: Record):
        self.graph, self.record = graph, record

    def __bool__(self) -> bool:
        return True

    def note(self, **attrs) -> None:
        self.record.attrs.update(attrs)

    def __enter__(self):
        self.graph.stack.append(self.record)
        if self.record.events is not None:
            self.record.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.record.events is not None:
            self.record.events[1].record()
        self.graph.stack.pop()
        return False


class GraphRecords:
    """The spans and counters of one CUDA graph's capture, in the order met
    (``records``), to be added to the session after each replay."""

    def __init__(self):
        self.records: list[Record] = []
        self.stack: list[Record] = []

    def _add(self, record: Record) -> Record:
        record.parent = self.stack[-1] if self.stack else None
        self.records.append(record)
        return record

    def open(self, name: str, device: bool, attrs: dict) -> _Captured:
        record = self._add(Record(name, attrs))
        if device:
            record.events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                                  for _ in range(2))
        return _Captured(self, record)

    def count(self, name: str, value) -> None:
        self._add(Record(name, {"value": value}))

    def emit(self, under) -> None:
        """After a replay, while a profiler records: a copy of every record
        into the session, with the replay's device times and counter values
        (waits for the replay), the top ones under the span ``under`` (the
        span the replay ran in; None for none). The next replay rewrites
        what this one read, so call it between the two."""
        if not on():
            return
        if any(r.events is not None for r in self.records):
            torch.cuda.current_stream().synchronize()
        top = under.record if under else None
        now = time.time_ns()
        copies: dict[int, Record] = {}
        for r in self.records:
            attrs = dict(r.attrs)
            if isinstance(attrs.get("value"), torch.Tensor):
                attrs["value"] = attrs["value"].clone()
            c = Record(r.name, attrs)
            c.parent = top if r.parent is None else copies[id(r.parent)]
            c.start_ns = c.end_ns = now
            if r.events is not None:
                c.replayed_ms = r.events[0].elapsed_time(r.events[1])
            copies[id(r)] = c
            _RECORDER.adopt(c)


_GRAPH: GraphRecords | None = None


@contextlib.contextmanager
def capture_records():
    """Around a CUDA graph's capture: every span and counter met inside is
    on, and is kept by the ``GraphRecords`` this yields (module
    docstring). One capture at a time, on the thread that captures."""
    global _GRAPH
    if _GRAPH is not None:
        raise RuntimeError("capture_records is already open")
    _GRAPH = GraphRecords()
    try:
        yield _GRAPH
    finally:
        _GRAPH = None


def span(name: str, *, device: bool = False, **attrs):
    """A context manager marking ``name`` (one of ``SPAN_NAMES``) while a
    profiler records; the shared no-op ``OFF`` otherwise. Both are truthy
    only when on, and take further attributes with ``note``."""
    if _GRAPH is not None:
        return _GRAPH.open(name, device, attrs)
    if not _profiler._is_profiler_enabled:
        _RECORDER.off_seen = True
        return OFF
    return _RECORDER.open(name, device, attrs)


def on() -> bool:
    """True while a profiler records and no CUDA graph is being captured,
    or while one is captured under ``capture_records``: when a span or
    counter would be recorded."""
    if _GRAPH is not None:
        return True
    if not _profiler._is_profiler_enabled:
        return False
    return not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


def count(name: str, value) -> None:
    """Record counter ``name`` (one of ``COUNTER_NAMES``) with ``value``
    while a profiler records; nothing otherwise."""
    if _GRAPH is not None:
        _GRAPH.count(name, value)
        return
    if not _profiler._is_profiler_enabled:
        _RECORDER.off_seen = True
        return
    _RECORDER.count(name, value)


def sessions() -> list[Session]:
    """The recorded sessions, oldest first."""
    return list(_RECORDER.sessions)


def clear() -> None:
    """Forget every session (the next span that finds the profiler on
    opens a new one)."""
    with _RECORDER._lock:
        _RECORDER.sessions.clear()
        _RECORDER.off_seen = True
