"""The general load generators, one per traffic kind.

A traffic file (``traffic/<mix>.json``) names its ``kind`` and holds every
parameter; a driver reads nothing else. Each driver

* makes its inputs from the run's seed (``__init__``),
* warms up every shape its traffic uses (``warm_up``, counted as set-up),
* runs the measured window (``window``): the end-to-end metrics, the
  requests attempted and failed, and the program's counters,
* keeps a seeded sample of the answers the window produced (``samples``:
  (check, key of the input, answer)) and works out each answer again with
  the plain reference (``reference``).

Kinds:

* ``apply_closed``: back-to-back ``GraphFilter.apply`` on panels drawn
  from a seeded device-resident pool; ``apply_signals_per_s`` is the
  panel columns enqueued in the window over the time until the device
  finished them.
* ``lasso_closed``: back-to-back ``solvers.fista`` solves of
  ``LassoProblem`` at a fixed budget; ``lasso_signals_per_s`` is the
  columns of completed solves over the time until the last completion.
* ``serve_open``: ``AsyncGraphFilterEngine`` on the wall clock in an open
  loop: a seeded trace, each request submitted at its due time, the engine
  stepped on its own clock; ``request_p99_ms`` is the 99th percentile of
  (answer on the host) - (due time) over every request due in the window,
  a failed (rejected or never answered) request counting as answered a
  minute after the close, when the run stops waiting.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gspbench import loadgen
from gspbench.reference import cheb
from gspbench.reference import fista as ref_fista

__all__ = ["KINDS", "TraceSlice", "Reservoir"]

GIVE_UP_S = 60.0  # how long past the window an answer is waited for


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream of unknown length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class TraceSlice:
    """Starts the tracer a quarter of the way into a window that began at
    ``t0`` (host clock) and stops it ``length_s`` after it started (or at
    the window's end); ``span`` is then the traced interval."""

    START_FRAC = 0.25

    def __init__(self, tracer, t0: float, seconds: float, length_s: float):
        self.tracer, self.length_s = tracer, length_s
        self.start_at = t0 + self.START_FRAC * seconds
        self.end = t0 + seconds
        self.done = tracer is None or not tracer.enabled
        self.span = (0.0, 0.0)

    def tick(self) -> None:
        if self.done:
            return
        now = time.perf_counter()
        if not self.tracer.active and now >= self.start_at:
            self.tracer.start()
            started = time.perf_counter()
            self.span = (started, started)
            self.stop_at = min(started + self.length_s, self.end)
        elif self.tracer.active and now >= self.stop_at:
            self.close()

    def close(self) -> None:
        if self.tracer is not None and self.tracer.active:
            self.tracer.stop()
            self.span = (self.span[0], time.perf_counter())
        self.done = True


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64."""
    want = want.to(torch.float64)
    diff = got.to(device=want.device, dtype=torch.float64) - want
    return float(diff.abs().max() / want.abs().max().clamp_min(1e-300))


class _Driver:
    span_names: tuple = ()

    def __init__(self, prog, traffic: dict, seed: int):
        self.prog, self.traffic, self.seed = prog, traffic, seed
        self.device = prog.coords.device
        self.rng = np.random.default_rng([seed, 1])

    def operands(self) -> dict:
        return {}

    def release(self) -> None:
        """Drop what holds the program's state (the samples stay)."""
        self.prog = None


class _ClosedLoop(_Driver):
    """Panels of noisy fields from a seeded device-resident pool, drawn in a
    seeded order; ``check`` names the number the sampled answers feed."""

    check = ""

    def __init__(self, prog, traffic, seed, gen):
        super().__init__(prog, traffic, seed)
        t = traffic
        self.pool = [loadgen.field_panel(prog.coords, gen, t["panel_width"], t["noise"])
                     for _ in range(t["pool"])]
        self.sequence = self.rng.integers(0, t["pool"], 4096)
        self.kept = Reservoir(t["samples"], np.random.default_rng([seed, 2]))

    def samples(self):
        return [(self.check, idx, answer) for idx, answer in self.kept.items]


class ApplyClosedLoop(_ClosedLoop):
    kind = "apply_closed"
    check = "apply_rel_err"
    span_names = ("apply",)

    def warm_up(self) -> None:
        for panel in self.pool[:1] * 2:
            self.prog.apply(panel)
        _sync(self.device)

    def window(self, seconds: float, tracer) -> dict:
        f = self.traffic["panel_width"]
        count, t0 = 0, time.perf_counter()
        trace = TraceSlice(tracer, t0, seconds, self.traffic["trace_s"])
        while time.perf_counter() - t0 < seconds:
            trace.tick()
            idx = int(self.sequence[count % len(self.sequence)])
            with tracer.span("apply"):
                out = self.prog.apply(self.pool[idx])
            self.kept.offer((idx, out))
            count += 1
        trace.close()
        _sync(self.device)
        wall = time.perf_counter() - t0
        return {"metrics": {"apply_signals_per_s": count * f / wall},
                "attempted": count, "failed": 0, "unanswered": 0, "counters": {"applies": count}}

    def operands(self) -> dict:
        return {"panel": self.pool[0]}

    def reference(self, check, keys, op, coeffs, lmax, dtype):
        return {k: cheb.apply(op, self.pool[k].to(dtype), coeffs, lmax) for k in set(keys)}


class LassoClosedLoop(_ClosedLoop):
    kind = "lasso_closed"
    check = "lasso_rel_err"
    span_names = ("solve",)

    def __init__(self, prog, traffic, seed, gen):
        super().__init__(prog, traffic, seed, gen)
        self.last = None

    def _solve(self, y, n_iters):
        from repro_torch.solvers import LassoProblem, fista

        problem = LassoProblem(filt=self.prog.filt, y=y, mu=self.traffic["mu"])
        return fista(problem, n_iters=n_iters, backend=self.prog.backend, **self.prog.opts)

    def warm_up(self) -> None:
        self._solve(self.pool[0], 2)
        _sync(self.device)

    def window(self, seconds: float, tracer) -> dict:
        f, n_iters = self.traffic["panel_width"], self.traffic["n_iters"]
        count, t0 = 0, time.perf_counter()
        trace = TraceSlice(tracer, t0, seconds, self.traffic["trace_s"])
        t_done = t0
        while time.perf_counter() - t0 < seconds:
            trace.tick()
            idx = int(self.sequence[count % len(self.sequence)])
            with tracer.span("solve"):
                res = self._solve(self.pool[idx], n_iters)
            _sync(self.device)
            t_done = time.perf_counter()
            self.kept.offer((idx, res.aux))
            self.last = res.aux
            count += 1
        trace.close()
        return {"metrics": {"lasso_signals_per_s": count * f / (t_done - t0)},
                "attempted": count, "failed": 0, "unanswered": 0, "counters": {"solves": count}}

    def operands(self) -> dict:
        return {"coeffs": self.last, "panel": self.pool[0]}

    def reference(self, check, keys, op, coeffs, lmax, dtype):
        t = self.traffic
        return {k: ref_fista.fista(op, self.pool[k].to(dtype), coeffs, lmax, t["mu"], t["n_iters"])
                for k in set(keys)}


class ServeOpenLoop(_Driver):
    kind = "serve_open"
    span_names = ("submit", "step", "wait")

    def __init__(self, prog, traffic, seed, gen):
        super().__init__(prog, traffic, seed)
        from repro_torch.serve import AsyncGraphFilterEngine, SchedulerConfig, lasso_panel_solver

        t = traffic
        self.signals = loadgen.signal_pool(prog.n, t["n_signals"], seed)
        config = SchedulerConfig(max_panel=t["max_panel"], min_bucket=t["min_bucket"],
                                 latency_budget_s=t["latency_budget_s"])
        solver = lasso_panel_solver(prog.filt, mu=t["solve_mu"], n_iters=t["solve_iters"],
                                    **prog.opts)
        self.engine = AsyncGraphFilterEngine(prog.filt, backend=prog.backend, solver=solver,
                                             config=config, opts=prog.opts, device=self.device)
        self.rate = float(t["rate"])
        self.kept = []
        self.report = {}

    def _submit(self, code: int, stream: int, signal: np.ndarray, tenant: str):
        if code == 0:
            return self.engine.submit(signal, tenant=tenant)
        if code == 1:
            return self.engine.submit_solve(signal, tenant=tenant)
        return self.engine.submit_frame(stream % self.traffic["frame_streams"], signal,
                                        tenant=tenant)

    def warm_up(self) -> None:
        """Record every bucket's program of the apply and solve lanes and
        run each frame stream's first two frames."""
        from repro_torch.filters import bucket_size

        t, eng = self.traffic, self.engine
        widths = sorted({bucket_size(k, t["max_panel"], floor=t["min_bucket"])
                         for k in range(1, t["max_panel"] + 1)})
        for code in (0, 1):
            for b in widths:
                for j in range(b):
                    self._submit(code, 0, self.signals[j % len(self.signals)], "warm")
                eng.drain()
        for s in range(t["frame_streams"]):
            for j in (s, s + 1):
                self._submit(2, s, self.signals[j % len(self.signals)], "warm")
            eng.drain()
        _sync(self.device)

    def run_trace(self, seconds: float, rate: float, tracer=None) -> dict:
        """Drive one seeded trace at ``rate`` over ``seconds`` on the wall
        clock; returns the report (also used by the knee sweep)."""
        from repro_torch.serve import AdmissionError

        t, eng = self.traffic, self.engine
        trace = loadgen.make_trace(t["n_streams"], seconds, rate, seed=self.seed,
                                   hot_frac=t["hot_frac"], hot_mass=t["hot_mass"],
                                   lane_mix=t["lane_mix"], n_tenants=t["n_tenants"],
                                   n_signals=t["n_signals"])
        n = len(trace["t_arrive"])
        lanes = trace["lane"]
        keep = set()
        for code, k in enumerate(t["samples"]):
            idx = np.flatnonzero(lanes == code)
            keep.update(int(i) for i in self.rng.choice(idx, min(k, len(idx)), replace=False))
        span = tracer.span if tracer is not None else (lambda name: _NULL)
        done_at = np.full(n, np.nan)
        lag = np.zeros(n)
        pending: dict[int, object] = {}
        rejected, panels = [], 0
        base = eng.stats()
        base_pad, base_slots = eng.pad_slots, eng.panel_slots
        clock = time.perf_counter

        def sweep():
            for i in [i for i, tk in pending.items() if tk.done]:
                tk = pending.pop(i)
                done_at[i] = tk.t_done
                if i in keep:
                    self.kept.append((int(lanes[i]), int(trace["signal"][i]), _answer(tk.result)))

        t0 = clock()
        due = t0 + trace["t_arrive"]
        trace_slice = TraceSlice(tracer, t0, seconds, t["trace_s"])
        for i in range(n):
            while clock() < due[i]:
                trace_slice.tick()
                with span("step"):
                    ran = eng.step()
                panels += ran
                if ran:
                    sweep()
                elif due[i] - clock() > 2e-4:
                    with span("wait"):
                        time.sleep(1e-4)
            with span("submit"):
                try:
                    pending[i] = self._submit(int(lanes[i]), int(trace["stream"][i]),
                                              self.signals[trace["signal"][i]],
                                              f"t{trace['tenant'][i]}")
                except AdmissionError:
                    rejected.append(i)
            lag[i] = clock() - due[i]
            trace_slice.tick()
            with span("step"):
                ran = eng.step()
            panels += ran
            if ran:
                sweep()
        t_close = max(t0 + seconds, due[-1])
        while pending and clock() < t_close + GIVE_UP_S:
            ran = eng.step()
            panels += ran
            sweep()
            if not ran:
                time.sleep(1e-4)
        trace_slice.close()
        failed = len(rejected) + len(pending)
        answered = np.where(np.isnan(done_at), np.inf, done_at)
        lat = np.where(np.isfinite(answered), answered, t_close + GIVE_UP_S) - due
        after = eng.stats()
        # Requests due before the traced slice began: the generator's
        # lateness there owes nothing to the profiler.
        before_trace = lag[due < trace_slice.span[0]] if trace_slice.span[0] else lag
        self.report = {
            "requests": n, "served": n - failed, "failed": failed, "unanswered": len(pending),
            "backlog_at_close": _backlog(due, answered, t0 + seconds),
            "backlog_growth": _backlog_growth(due, answered, t0, seconds),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "lag_p99_ms": float(np.percentile(before_trace, 99) * 1e3) if before_trace.size else None,
            "panels": panels, "busy_s": after["busy_s"] - base["busy_s"],
            "pad_slots": eng.pad_slots - base_pad, "panel_slots": eng.panel_slots - base_slots,
            "recompiles": after["recompiles"] - base["recompiles"],
        }
        return self.report

    def window(self, seconds: float, tracer) -> dict:
        rep = self.run_trace(seconds, self.rate, tracer)
        return {"metrics": {"request_p99_ms": rep["p99_ms"]},
                "attempted": rep["requests"], "failed": rep["failed"],
                "unanswered": rep["unanswered"], "counters": rep}

    def release(self) -> None:
        super().release()
        self.engine = None

    _CHECKS = ("apply_rel_err", "solve_rel_err", "frame_rel_err")

    def samples(self):
        return [(self._CHECKS[code], signal, answer) for code, signal, answer in self.kept]

    def reference(self, check, keys, op, coeffs, lmax, dtype):
        keys = sorted(set(keys))
        if not keys:
            return {}
        y = torch.as_tensor(np.stack([self.signals[k] for k in keys], axis=1),
                            device=self.device, dtype=dtype)
        if check == "solve_rel_err":
            t = self.traffic
            out = ref_fista.fista(op, y, coeffs, lmax, t["solve_mu"], t["solve_iters"])
        else:
            out = cheb.apply(op, y, coeffs, lmax)
        return {k: out[:, :, j] for j, k in enumerate(keys)}


def _backlog(due: np.ndarray, answered: np.ndarray, t: float) -> int:
    """Requests due by ``t`` and not answered by then."""
    return int(np.count_nonzero(due <= t) - np.count_nonzero(answered <= t))


def _backlog_growth(due, answered, t0: float, seconds: float) -> float:
    """How far the backlog grew over the window's second half: the slope of
    a line fitted to it at 100 instants, times the half's length."""
    ts = np.linspace(t0 + seconds / 2, t0 + seconds, 100)
    backlog = [_backlog(due, answered, t) for t in ts]
    return float(np.polyfit(ts - ts[0], backlog, 1)[0] * seconds / 2)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _answer(result) -> torch.Tensor:
    """A request's (eta, N) answer: an apply's columns, a solve's
    coefficients, a frame's output."""
    for attr in ("aux", "out"):
        value = getattr(result, attr, None)
        if isinstance(value, torch.Tensor):
            return value.clone()
    return result.clone()


KINDS = {d.kind: d for d in (ApplyClosedLoop, LassoClosedLoop, ServeOpenLoop)}
