"""Profiler arithmetic: device busy time, idle gaps, time per call.

``Tracer`` records one slice of a run's window with ``torch.profiler``
(host and device activity). Inside the slice the benchmark opens named
host spans around its calls into the program (``Tracer.span``). From the
trace it takes:

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) inside the slice, and ``window_s``, the slice's length;
* ``device_ops``: device seconds per operation name, the largest first;
* ``idle_gaps``: the gaps between busy intervals, each named by the
  innermost span open on the host at its midpoint (``none`` where no span
  was open), summed per name, the largest first.

``device_seconds_per_call`` is the summed device time of every kernel a
call launches, from a profiler session of its own; ``event_seconds`` the
median CUDA-event time of a call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
import warnings

import torch

__all__ = [
    "TraceSummary",
    "Tracer",
    "merge_intervals",
    "summarize",
    "device_seconds_per_call",
    "event_seconds",
]

WINDOW_SPAN = "gspbench.traced"
TOP = 10
NAME_CHARS = 96


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces and
    its argument list, at most ``NAME_CHARS`` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if "(" in name[1:]:
        name = name[:name.index("(", 1)]
    return name[:NAME_CHARS]


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list

    @property
    def idle_share(self) -> float:
        """Percent of the traced slice in which no device operation ran."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans, points) -> list[str]:
    """For each of the sorted ``points``, the name of the innermost host
    span (spans of one thread nest) open at it, or ``none``."""
    order = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    stack, j, names = [], 0, []
    for p in points:
        while j < len(order) and order[j][1] <= p:
            while stack and stack[-1][2] <= order[j][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        names.append(stack[-1][0] if stack else "none")
    return names


def summarize(device_events, spans, window, *, unit: float = 1e-6) -> TraceSummary:
    """Reduce a trace to a ``TraceSummary``.

    ``device_events`` are (name, start, end) of device operations,
    ``spans`` (name, start, end) of host spans and ``window`` the slice's
    (start, end), all in one clock whose tick is ``unit`` seconds.
    """
    lo, hi = window
    per_op: dict[str, float] = {}
    clipped = []
    for name, s, e in device_events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            clipped.append((s, e))
            per_op[name] = per_op.get(name, 0.0) + (e - s) * unit
    busy = merge_intervals(clipped)
    gaps, cursor = [], lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    per_gap: dict[str, float] = {}
    for (g0, g1), name in zip(gaps, _innermost(spans, [0.5 * (g0 + g1) for g0, g1 in gaps])):
        per_gap[name] = per_gap.get(name, 0.0) + (g1 - g0) * unit

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(
        busy_s=sum(e - s for s, e in busy) * unit,
        window_s=(hi - lo) * unit,
        device_ops=top(per_op),
        idle_gaps=top(per_gap),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Traces one slice of a run when ``enabled``; a no-op otherwise.

    ``span(name)`` marks a host span (only while the slice is traced);
    ``start()`` and ``stop()`` bound the slice, each after a synchronise,
    and ``finish()``, called after the window, reduces it to ``summary``.
    """

    def __init__(self, enabled: bool, device: torch.device, span_names=()):
        self.enabled = enabled
        self.device = device
        self.span_names = frozenset(span_names) | {WINDOW_SPAN}
        self.active = False
        self.summary: TraceSummary | None = None
        self._prof = None
        self._window = None

    def warm_up(self) -> None:
        """One empty session, so that the profiler's one-time start-up is
        paid in set-up and not inside the traced slice."""
        if self.enabled:
            self.start()
            self.stop()
            self._prof = None

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        self.active = True

    def stop(self) -> None:
        """End the slice; the trace is reduced later, by ``finish``, so that
        reading it costs the window nothing."""
        _sync(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False

    def finish(self) -> TraceSummary | None:
        """Reduce the traced slice (once) and return the summary."""
        from torch.autograd import DeviceType

        if self._prof is None or self.active:
            return self.summary
        device_events, spans, window = [], [], None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "clears events at the end of each cycle"
            events = self._prof.events()
        for ev in events:
            s, e = ev.time_range.start, ev.time_range.end
            user = getattr(ev, "is_user_annotation", False) or ev.name in self.span_names
            if ev.device_type == DeviceType.CUDA:
                if not user:
                    device_events.append((short_name(ev.name), s, e))
            elif ev.name == WINDOW_SPAN:
                window = (s, e)
            elif ev.name in self.span_names:
                spans.append((ev.name, s, e))
        self._prof = None
        if window is not None:
            self.summary = summarize(device_events, spans, window)
        return self.summary


def device_seconds_per_call(fn, device: torch.device, calls: int = 5) -> float | None:
    """Summed device seconds of every kernel one call of ``fn`` launches,
    over ``calls`` calls after one; None off the card or when the
    profiler recorded no device time."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
    return total_us * 1e-6 / calls if total_us > 0 else None


def event_seconds(fn, device: torch.device, reps: int = 5) -> float:
    """Median seconds of one call of ``fn`` over ``reps`` calls after one:
    CUDA events on the card, the host clock around a finished call on
    the CPU."""
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)
