"""``repro_torch.telemetry``: spans off without a profiler, sessions, the
span tree of the serving engine and of FISTA on ``bsr``, the recorder's
clock against the profiler's, and ``FrameResult.host_s`` under spans."""

import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.filters import GraphFilter
from repro_torch.serve import AsyncGraphFilterEngine, SchedulerConfig, lasso_panel_solver
from repro_torch.solvers import LassoProblem, fista
from repro_torch.stream import StreamingFilter

N = 96


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def filt():
    g = tgraph.connected_sensor_graph(torch.Generator().manual_seed(4), n=N, sigma=0.17,
                                      kappa=0.18, device="cpu")
    lmax = float(g.lmax_bound())
    return GraphFilter.from_multipliers(tmult.sgwt_filter_bank(lmax, 3), 8, graph=g, lmax=lmax)


@pytest.fixture(autouse=True)
def fresh():
    telemetry.clear()
    yield
    telemetry.clear()


def _signals(k, seed=0):
    return np.random.default_rng(seed).normal(size=(k, N)).astype(np.float32)


def _children(session, rec):
    return [r for r in session.records if r.parent is rec]


def test_off_span_is_the_shared_no_op(filt, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("touched while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(telemetry.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    sp = telemetry.span("filter.apply", device=True, backend="bsr")
    assert sp is telemetry.OFF and not sp
    with sp as inner:
        inner.note(k=1)
    # The instrumented paths run with every span off.
    y = torch.as_tensor(_signals(4).T.copy())
    fista(LassoProblem(filt=filt, y=y, mu=0.5), n_iters=2, backend="bsr")
    eng = AsyncGraphFilterEngine(filt, backend="bsr", device="cpu",
                                 solver=lasso_panel_solver(filt, n_iters=2))
    tickets = [eng.submit(s) for s in _signals(3)] + [eng.submit_solve(_signals(1)[0]),
                                                      eng.submit_frame("s", _signals(1)[0])]
    eng.drain()
    assert all(t.done for t in tickets)
    assert telemetry.sessions() == []


def test_sessions_open_when_the_profiler_starts_again():
    with telemetry.span("serve.pack"):
        pass
    with _profiled():
        with telemetry.span("serve.panel") as outer:
            outer.note(lane="apply")
            with telemetry.span("serve.pack", b=8):
                pass
    with telemetry.span("serve.pack"):  # off: the next profiled span opens session 2
        pass
    with _profiled():
        with telemetry.span("serve.resolve"):
            pass
    first, second = telemetry.sessions()
    assert [r.name for r in first.records] == ["serve.panel", "serve.pack"]
    panel, pack = first.records
    assert panel.parent is None and pack.parent is panel
    assert panel.attrs == {"lane": "apply"} and pack.attrs == {"b": 8}
    assert panel.start_ns <= pack.start_ns <= pack.end_ns <= panel.end_ns
    assert [r.name for r in second.records] == ["serve.resolve"]
    assert first.dropped == second.dropped == 0


def test_session_caps_its_records(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_RECORDS", 3)
    with _profiled():
        for _ in range(5):
            with telemetry.span("bsr.union"):
                pass
    (session,) = telemetry.sessions()
    assert len(session.records) == 3 and session.dropped == 2


def test_device_span_has_no_events_on_the_cpu():
    with _profiled():
        with telemetry.span("filter.apply", device=True) as sp:
            assert sp
    (rec,) = telemetry.sessions()[0].records
    assert rec.events is None and rec.device_ms() is None and rec.host_ms >= 0.0


def test_engine_span_tree(filt):
    eng = AsyncGraphFilterEngine(filt, backend="bsr", device="cpu",
                                 config=SchedulerConfig(max_panel=8, min_bucket=4),
                                 solver=lasso_panel_solver(filt, n_iters=2))
    sig = _signals(12, seed=1)
    for lane in (eng.submit, eng.submit_solve):  # build every bucket's program first
        for width in (4, 8):
            for j in range(width):
                lane(sig[j])
            eng.drain()
    submitted = []
    with _profiled():
        for i in range(11):
            submitted.append(eng.submit(sig[i]))
            if i % 3 == 0:
                submitted.append(eng.submit_solve(sig[i]))
            if i % 4 == 0:
                submitted.append(eng.submit_frame(i % 2, sig[i]))
            eng.step()
        eng.drain()
    assert all(t.done for t in submitted)
    (session,) = telemetry.sessions()
    panels = session.named("serve.panel")
    by_lane = {lane: [p for p in panels if p.attrs["lane"] == lane]
               for lane in ("apply", "solve", "frame")}
    assert all(by_lane.values())
    stages = ["serve.pack", "serve.upload", "serve.replay", "serve.copy_back", "serve.resolve"]
    for p in by_lane["apply"] + by_lane["solve"]:
        assert p.parent is None
        assert [c.name for c in _children(session, p)] == stages
        pack = _children(session, p)[0]
        assert pack.attrs["b"] in (4, 8) and pack.attrs["k"] == p.attrs["k"] <= pack.attrs["b"]
    for p in by_lane["frame"]:
        kids = _children(session, p)
        assert [c.name for c in kids] == ["serve.frame"] * p.attrs["k"] + ["serve.resolve"]
        assert [c.attrs["tid"] for c in kids[:-1]] == p.attrs["tids"]
    # Every request's queue wait, once, beside its ticket's id.
    tids = [t for p in panels for t in p.attrs["tids"]]
    waits = [w for p in panels for w in p.attrs["queue_wait_s"]]
    assert sorted(tids) == sorted(t.tid for t in submitted)
    assert len(waits) == len(tids) and min(waits) >= 0.0
    assert sum(p.attrs["k"] for p in panels) == len(submitted)
    # The solve lane's program runs FISTA: iterations inside the replay span.
    replay = _children(session, by_lane["solve"][0])[2]
    iters = [r for r in session.named("solver.iteration") if r.parent is replay]
    assert [r.attrs["index"] for r in iters] == [0, 1]
    assert not session.named("serve.capture")


def test_engine_capture_span_on_a_cache_miss(filt):
    eng = AsyncGraphFilterEngine(filt, backend="bsr", device="cpu")
    with _profiled():
        eng.submit(_signals(1)[0])
        eng.drain()
        eng.submit(_signals(1)[0])
        eng.drain()
    names = [r.name for r in telemetry.sessions()[0].records if r.parent is not None
             and r.parent.name == "serve.panel"]
    assert names.count("serve.capture") == 1 and names.count("serve.replay") == 1
    assert eng.recompiles == 1


def test_fista_iterations_hold_one_apply_and_one_adjoint(filt):
    y = torch.as_tensor(_signals(4).T.copy())
    with _profiled():
        res = fista(LassoProblem(filt=filt, y=y, mu=0.5), n_iters=3, backend="bsr")
    assert res.iterations == 3
    session = telemetry.sessions()[0]
    iters = session.named("solver.iteration")
    assert [(r.attrs["method"], r.attrs["index"]) for r in iters] == [("fista", i)
                                                                     for i in range(3)]
    for it in iters:
        kids = _children(session, it)
        assert sorted(c.name for c in kids) == ["filter.adjoint", "filter.apply"]
        for c in kids:
            assert c.attrs["backend"] == "bsr"
            grand = [g.name for g in _children(session, c)]
            if c.name == "filter.apply":
                assert grand == ["bsr.permute", "bsr.tiling", "bsr.union", "bsr.unpermute"]
            else:
                assert grand == ["bsr.permute", "bsr.recurrence", "bsr.unpermute"]
    # The initial forward apply and the final adjoint sit outside the loop.
    tops = [r.name for r in session.records if r.parent is None]
    assert tops == ["filter.apply"] + ["solver.iteration"] * 3 + ["filter.adjoint"]


def test_recorder_shares_the_profilers_clock():
    with _profiled() as prof:
        for _ in range(200):
            with telemetry.span("bsr.union"):
                time.sleep(1e-5)
    recs = telemetry.sessions()[0].records
    events = sorted((e for e in prof.events() if e.name == "bsr.union"),
                    key=lambda e: e.time_range.start)
    assert len(events) == len(recs) == 200
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    offsets_us = [abs(r.start_ns - (base_ns + 1e3 * e.time_range.start)) * 1e-3
                  for r, e in zip(recs, events)]
    assert statistics.median(offsets_us) <= 20.0


def test_frame_host_s_keeps_its_meaning(filt):
    f0 = _signals(1, seed=5)[0]
    f1 = f0.copy()
    f1[:3] += 1.0
    for traced in (False, True):
        telemetry.clear()
        lane = StreamingFilter(filt, backend="dense", device="cpu")
        if traced:
            with _profiled():
                r0, r1 = lane.push(f0), lane.push(f1)
        else:
            r0, r1 = lane.push(f0), lane.push(f1)
        assert (r0.mode, r1.mode) == ("full", "delta")
        assert r0.host_s == 0.0 and 0.0 < r1.host_s <= r1.latency_s
        walks = [r for s in telemetry.sessions() for r in s.named("stream.walk_delta")]
        if traced:
            (walk,) = walks
            assert r1.host_s * 1e3 <= walk.host_ms <= r1.latency_s * 1e3
        else:
            assert walks == []


def test_graph_records_are_added_after_each_replay():
    """Spans and counters met under ``capture_records`` are kept, not put in
    a session; each ``emit`` under a profiler adds a copy of them under the
    span it is given, with the counter values as they are then (a graph
    rewrites them in place on every replay)."""
    value = torch.zeros(3, dtype=torch.int64)
    with telemetry.capture_records() as records:
        assert telemetry.on()
        with telemetry.span("moe.experts", tokens=4):
            telemetry.count("moe.dropped_tokens", value)
        telemetry.count("moe.expert_tokens", value)
    assert not telemetry.on() and telemetry.sessions() == []
    assert [r.name for r in records.records] == ["moe.experts", "moe.dropped_tokens",
                                                 "moe.expert_tokens"]
    records.emit(None)  # the profiler is off: nothing
    with _profiled():
        for step in range(2):
            value.fill_(step + 1)
            with telemetry.span("lm.decode_step", position=step) as sp:
                pass
            records.emit(sp)
    (session,) = telemetry.sessions()
    steps = session.named("lm.decode_step")
    assert len(steps) == 2 and len(session.records) == 8
    for step, rec in enumerate(steps):
        (experts, counts) = _children(session, rec)
        assert experts.name == "moe.experts" and experts.attrs == {"tokens": 4}
        (dropped,) = _children(session, experts)
        assert counts.attrs["value"].tolist() == [step + 1] * 3
        assert dropped.attrs["value"].tolist() == [step + 1] * 3
        assert experts.device_ms() is None and experts.host_ms == 0.0
