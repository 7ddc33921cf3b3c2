"""Batched serving engines.

Mirrors ``repro/serve/engine.py``. Two workloads share the static-batching
pattern:

``ServeEngine`` — LM prefill/decode with per-request stop handling over
``repro_torch.models.lm``. It runs eagerly under ``torch.inference_mode``
(the reference's ``jax.jit`` has no counterpart yet), keeps the params and
the cache on its ``device`` (default ``cuda``, raising without it) and
hands the generated ids back as a host numpy array. Greedy decoding
(``temperature=0``) gives the reference's tokens; sampling draws from a
``torch.Generator`` seeded with ``seed``, deterministic per seed but not
jax's stream. Beside ``generate`` it keeps resident sessions (no
counterpart in the reference; latent-attention models): ``open_sessions``
prefills B documents of one length into one cache, one at a time, and
each ``turn`` extends every session by a question, decodes a greedy
answer (on a card, after the first turn, by replaying the decode step
recorded as a CUDA graph) and rewinds the cache to the documents' end.

``GraphFilterEngine`` — graph-signal filtering as a service: incoming
(N,)-signal requests are packed into an (N, F) panel and answered by ONE
``GraphFilter.apply`` — the union recurrence is F-blind, so batching
amortizes the whole Krylov sequence (and, on the ``bsr`` backend, feeds
the fused union kernel one wide panel). This is the serving face of the
paper's "one recurrence, eta outputs" economics.

The same engine serves *iterative solves* (solve-as-a-service): requests
queue on a second lane and one FISTA/ISTA run over the packed (N, F)
panel answers F clients at once (configure with ``solver=``, e.g.
:func:`lasso_panel_solver`). A third lane serves *streams*
(``submit_frame`` / ``flush_frames``): frames keyed by stream id are
answered by per-stream :class:`repro_torch.stream.StreamingFilter` state.

Device and answers. The engine runs on ``device=`` (default ``cuda``,
raising without it), which must be the filter's graph's device. Panels
are packed on the host and uploaded once; apply answers are (eta, N) CPU
tensors and solve answers ``SolveResult`` s with CPU ``x`` and ``aux``
columns, all from ONE device-to-host copy per panel into storage of the
panel's own, so no later panel can overwrite an answer. Frame answers are
the ``FrameResult`` s of ``StreamingFilter.push``, whose ``out`` stays on
the device. This engine stays eager, as the reference's does: every
panel is a plain ``filt.apply`` (the async engine holds the programs).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.device import pinned_uploads, resolve_device, upload
from repro_torch.filters import GraphFilter
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.sharding import ShardingRules
from repro_torch.solvers import LassoProblem, SolveResult, solve as solve_problem
from repro_torch.stream import FrameResult, StreamingFilter
from repro_torch.stream.api import stream_device
from repro_torch.tree import tree_leaves

__all__ = [
    "make_decode_step",
    "make_prefill",
    "ServeEngine",
    "Sessions",
    "GraphFilterEngine",
    "lasso_panel_solver",
]


def make_decode_step(
    cfg: ModelConfig, par: ParallelConfig, rules: ShardingRules | None = None
) -> Callable:
    """``decode_step(params, token, cache) -> (logits, cache)``; the cache
    is updated in place (``lm.decode_step``)."""
    def decode_step(params, token, cache):
        return lm.decode_step(params, token, cache, cfg, par, rules)

    return decode_step


def make_prefill(
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
    s_max: int | None = None,
) -> Callable:
    """``prefill(params, tokens) -> (last logits, cache)``."""
    def prefill(params, tokens):
        return lm.prefill(params, tokens, cfg, par, rules, s_max=s_max)

    return prefill


def _copy_row(dst: dict, src: dict, row: int) -> None:
    """A one-row cache ``src`` into batch row ``row`` of ``dst`` (caches of
    one ``s_max``): each layer's row tensors, whose batch axis follows the
    layer's stacking axes, its length, and the position."""
    for d, r in zip([*dst.get("prefix", []), *dst["blocks"]],
                    [*src.get("prefix", []), *src["blocks"]]):
        axis = d["len"].dim()
        for name, t in d.items():
            if name != "len":
                t.select(axis, row).copy_(r[name].select(axis, 0))
        d["len"].copy_(r["len"])
    dst["pos"].copy_(src["pos"])


@dataclasses.dataclass
class _DecodeGraphs:
    """The sessions' decode step recorded as CUDA graphs that read the token
    from ``token``: ``plain`` and ``instrumented`` (its spans and counters
    kept by ``telemetry.capture_records``), each ``(graph, logits,
    records)`` with ``logits`` its static output; ``held``, the cached
    uploads the captures read (``device.pinned_uploads``)."""

    token: torch.Tensor
    plain: tuple
    instrumented: tuple
    held: dict


@dataclasses.dataclass
class Sessions:
    """Resident sessions: one cache whose B rows each hold a document of
    ``length`` tokens, with the engine's ``s_max`` rows of room, and on a
    CUDA device the decode step recorded over that cache (``graphs``,
    after the first turn)."""

    cache: dict
    length: int
    graphs: _DecodeGraphs | None = dataclasses.field(default=None, repr=False)

    @property
    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.cache))


@dataclasses.dataclass
class ServeEngine:
    """Static-slot batched generation on ``device``.

    ``params`` must already be on the engine's device. Without ``eos_id``
    a generation makes no host sync until its last step: the tokens
    collect on the device and come back in one copy. ``sessions`` holds
    the resident sessions ``open_sessions`` built, or None."""

    cfg: ModelConfig
    par: ParallelConfig
    params: Any
    s_max: int = 128
    temperature: float = 0.0
    rules: ShardingRules | None = None
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for t in tree_leaves(self.params):
            if t.device != self.device:
                raise ValueError(f"params on {t.device}, engine on {self.device}")
        self._decode = make_decode_step(self.cfg, self.par, self.rules)
        self._prefill = make_prefill(self.cfg, self.par, self.rules, s_max=self.s_max)
        self.sessions: Sessions | None = None

    @torch.inference_mode()
    def open_sessions(self, documents: np.ndarray) -> Sessions:
        """documents (B, S) ids -> B resident sessions in one cache of
        ``s_max`` rows. Each document is prefilled alone and its one-row
        cache copied into its row, so one document's prefill and cache
        are the largest transient."""
        b, s = documents.shape
        if s >= self.s_max:
            raise ValueError(f"documents of {s} tokens leave no room in s_max={self.s_max}")
        self.sessions = None
        cache = lm.init_cache(self.cfg, b, self.s_max, self.cfg.dtype(), self.device)
        for i in range(b):
            with telemetry.span("lm.session_prefill", device=True, rows=1, tokens=s):
                tokens = upload(np.asarray(documents[i:i + 1], np.int64), self.device)
                _copy_row(cache, self._prefill(self.params, tokens)[1], i)
        self.sessions = Sessions(cache=cache, length=s)
        return self.sessions

    @torch.inference_mode()
    def turn(self, questions: np.ndarray, n: int) -> tuple[np.ndarray, torch.Tensor]:
        """One turn of every session: extend each by its question (B, q),
        decode ``n`` greedy answer tokens, then rewind the cache to the
        documents' end. Returns the answers' ids (B, n) on the host and
        the logits that chose them, (B, n, V) on the device.

        On a CUDA device the first turn decodes eagerly and then records
        the decode step (``_record_decode``); later turns replay it, the
        instrumented graph while a profiler records. A step reads its
        position from the cache, so one recording serves every turn."""
        sess = self.sessions
        if sess is None:
            raise ValueError("no sessions: call open_sessions first")
        b, q = questions.shape
        if sess.length + q + n - 1 > self.s_max:
            raise ValueError(f"a turn of {q} + {n} tokens does not fit s_max={self.s_max} "
                             f"after {sess.length}")
        if telemetry.on():
            telemetry.count("lm.latent_cache_bytes", sess.cache_bytes)
        tokens = upload(np.asarray(questions, np.int64), self.device)
        with telemetry.span("lm.extend", device=True, rows=b, tokens=q):
            logits, cache = lm.extend(self.params, tokens, sess.cache, self.cfg, self.par,
                                      self.rules, last_only=True)
        out = torch.empty((b, n, logits.shape[-1]), dtype=logits.dtype, device=self.device)
        ids = torch.empty((b, n), dtype=torch.int64, device=self.device)
        for t in range(n):
            out[:, t] = logits[:, -1]
            ids[:, t] = torch.argmax(logits[:, -1], dim=-1)
            if t + 1 < n:
                with telemetry.span("lm.decode_step", device=True, rows=b,
                                    position=sess.length + q + t) as sp:
                    logits, records = self._session_step(ids[:, t:t + 1])
                if records is not None:
                    records.emit(sp)
        answers = ids.cpu().numpy()
        if sess.graphs is None and self.device.type == "cuda":
            sess.graphs = self._record_decode(b)
        lm.rewind(cache, sess.length, self.cfg)
        return answers, out

    def _session_step(self, token: torch.Tensor):
        """One decode step of the sessions on token (B, 1): (logits (B, 1,
        V), the replayed graph's records or None). A replay's logits are
        its static output, rewritten by the next replay."""
        graphs = self.sessions.graphs
        if graphs is None:
            return self._decode(self.params, token, self.sessions.cache)[0], None
        graphs.token.copy_(token)
        graph, logits, records = graphs.instrumented if telemetry.on() else graphs.plain
        graph.replay()
        return logits, records

    def _record_decode(self, b: int) -> _DecodeGraphs:
        """The sessions' decode step recorded twice, plain and instrumented,
        on one static token input. Recording runs nothing; each graph is
        then replayed once at the documents' end (rewound before each), so
        that no later turn makes a graph's first replay. The caller
        rewinds after."""
        sess = self.sessions
        token = torch.zeros((b, 1), dtype=torch.int64, device=self.device)
        recorded = []
        with pinned_uploads() as held:
            for instrumented in (False, True):
                graph = torch.cuda.CUDAGraph()
                with contextlib.ExitStack() as stack:
                    records = (stack.enter_context(telemetry.capture_records())
                               if instrumented else None)
                    stack.enter_context(torch.cuda.graph(graph))
                    logits = self._decode(self.params, token, sess.cache)[0]
                recorded.append((graph, logits, records))
        for graph, _, _ in recorded:
            lm.rewind(sess.cache, sess.length, self.cfg)
            graph.replay()
        return _DecodeGraphs(token, *recorded, held)

    @torch.inference_mode()
    def generate(
        self, prompts: np.ndarray, max_new_tokens: int, eos_id: int | None = None, seed: int = 0
    ) -> np.ndarray:
        """prompts: (B, S0) int32 -> (B, max_new_tokens) generated ids."""
        b = prompts.shape[0]
        tokens = upload(np.asarray(prompts, np.int64), self.device)
        logits, cache = self._prefill(self.params, tokens)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        token = self._sample(logits[:, -1], gen)
        if eos_id is None:
            out = torch.zeros((b, max_new_tokens), dtype=torch.int64, device=self.device)
            for t in range(max_new_tokens):
                out[:, t] = token[:, 0]
                if t + 1 < max_new_tokens:
                    logits, cache = self._decode(self.params, token, cache)
                    token = self._sample(logits[:, 0], gen)
            return out.cpu().numpy().astype(np.int32)
        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        for t in range(max_new_tokens):
            out[:, t] = np.where(done, eos_id, token[:, 0].cpu().numpy())
            done |= out[:, t] == eos_id
            if done.all():
                break
            if t + 1 < max_new_tokens:
                logits, cache = self._decode(self.params, token, cache)
                token = self._sample(logits[:, 0], gen)
        return out

    def _sample(self, logits, gen: torch.Generator):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        # Gumbel-max: argmax(logits / T + G) samples softmax(logits / T).
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self.temperature + gumbel, dim=-1)[:, None]



_UNSET = object()


def _bind_solver_backend(solver, backend: str):
    """Bind a backend-less panel solver to the engine's backend.

    A :func:`lasso_panel_solver` built without an explicit ``backend=``
    declares ``backend=None`` ("inherit the engine's"), so the apply and
    solve lanes cannot silently disagree. Binding returns a *copy* via
    ``dataclasses.replace`` — mutating in place would leak this engine's
    backend into a solver object shared with another engine.

    Solvers with an explicit backend — or arbitrary callables that never
    declare one — pass through untouched. A non-dataclass solver that
    *does* declare ``backend=None`` is refused loudly, since
    ``dataclasses.replace`` cannot copy it.
    """
    if solver is None:
        return None
    declared = getattr(solver, "backend", _UNSET)
    if declared is not None:
        # Explicit backend, or no backend contract at all: use as-is.
        return solver
    if not dataclasses.is_dataclass(solver):
        raise TypeError(
            f"solver {type(solver).__name__!r} declares backend=None "
            "(meaning 'inherit the engine's backend') but is not a "
            "dataclass, so the engine cannot bind a copy with "
            "dataclasses.replace(). Construct it with an explicit "
            "backend= instead."
        )
    return dataclasses.replace(solver, backend=backend)


def host_copy(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors in one new host buffer, through one device-to-host copy
    (several tensors are packed on the device first)."""
    if len(tensors) == 1:
        t = tensors[0]
        return (t.cpu() if t.device.type != "cpu" else t.clone(),)
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu()
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return tuple(out)


def solve_answers(res: SolveResult, k: int) -> list[SolveResult]:
    """Split a panel ``SolveResult`` into its first ``k`` columns on the
    host: ``x``, a tensor ``aux`` and a device ``history`` come down in one
    copy; the history becomes the float64 numpy trace."""
    parts = [res.x]
    has_aux = isinstance(res.aux, torch.Tensor)
    if has_aux:
        parts.append(res.aux)
    if isinstance(res.history, torch.Tensor):
        parts.append(res.history)
    host = host_copy(*parts)
    x = host[0]
    aux = host[1] if has_aux else None
    history = res.history
    if isinstance(history, torch.Tensor):
        history = host[-1].numpy().astype(np.float64)
    return [
        dataclasses.replace(res, x=x[:, i], aux=aux[..., i] if has_aux else res.aux,
                            history=history)
        for i in range(k)
    ]


@dataclasses.dataclass
class GraphFilterEngine:
    """Micro-batching front end for a :class:`GraphFilter`.

    Requests (one (N,) signal each) accumulate until ``panel_width`` are
    pending, then one backend apply answers the whole panel. A fixed
    panel width keeps the kernels on one F (the partial last panel is
    zero-padded; zero columns are exact pass-throughs).

    Parameters
    ----------
    filt : GraphFilter
        The filter to serve (graph already bound for graph-bound backends).
    backend : str
        ``GraphFilter`` backend to answer panels with.
    panel_width : int
        F dimension of the served panel; requests per apply.
    opts : dict
        Extra backend options forwarded to every apply.
    solver : callable, optional
        ``panel -> SolveResult`` for the solve lane
        (:func:`lasso_panel_solver`).
    stream_opts : dict
        Keyword options for the per-stream
        :class:`repro_torch.stream.StreamingFilter` lanes
        (``max_delta_frac``, ``refresh_every``, ``n_parts``, ...).
    device : str or torch.device, optional
        Default ``cuda`` (raises without it); must be the filter's
        graph's device. The stream lanes run on it too.
    """

    filt: GraphFilter
    backend: str = "bsr"
    panel_width: int = 8
    opts: dict = dataclasses.field(default_factory=dict)
    solver: Callable[[torch.Tensor], SolveResult] | None = None
    stream_opts: dict = dataclasses.field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        self.device = stream_device(self.filt, self.device)
        self._pending: list[np.ndarray] = []
        self._pending_solves: list[np.ndarray] = []
        self._pending_frames: list[tuple[Any, np.ndarray]] = []
        self._streams: dict[Any, StreamingFilter] = {}
        self.served = 0
        self.applies = 0
        self.solved = 0
        self.solves = 0
        self.frames_served = 0
        self.stream_words = 0
        self.stream_latency_s = 0.0
        self.solver = _bind_solver_backend(self.solver, self.backend)

    def submit(self, signal) -> list[torch.Tensor] | None:
        """Queue one (N,) signal; returns the panel's (eta, N) results —
        one CPU tensor per queued request, submission order — when it
        fills."""
        self._pending.append(np.asarray(signal))
        if len(self._pending) >= self.panel_width:
            return self.flush()
        return None

    def flush(self) -> list[torch.Tensor] | None:
        """Answer all pending requests now (pads a partial panel)."""
        if not self._pending:
            return None
        panel, k = self._pack(self._pending)
        out = self.filt.apply(upload(panel, self.device), backend=self.backend, **self.opts)
        (out,) = host_copy(out)  # (eta, N, panel_width)
        self._pending.clear()
        self.served += k
        self.applies += 1
        return [out[:, :, i] for i in range(k)]

    # -- solve-as-a-service lane -----------------------------------------

    def submit_solve(self, signal) -> list[SolveResult] | None:
        """Queue one (N,) signal for the iterative-solve lane; returns the
        per-request :class:`SolveResult` list (submission order) when the
        panel fills."""
        if self.solver is None:
            raise ValueError("engine has no solver=; build one with lasso_panel_solver()")
        self._pending_solves.append(np.asarray(signal))
        if len(self._pending_solves) >= self.panel_width:
            return self.flush_solves()
        return None

    def flush_solves(self) -> list[SolveResult] | None:
        """Solve all pending requests now (pads a partial panel).

        The F queued signals are packed into one (N, F) panel and answered
        by a SINGLE solver run whose every filter call carries the whole
        panel. Each caller receives the shared iteration/communication
        metadata with its own solution column.
        """
        if not self._pending_solves:
            # empty lane drains harmlessly, like flush() — even with no
            # solver configured
            return None
        if self.solver is None:
            raise ValueError("engine has no solver=; build one with lasso_panel_solver()")
        panel, k = self._pack(self._pending_solves)
        res = self.solver(upload(panel, self.device))
        self._pending_solves.clear()
        self.solved += k
        self.solves += 1
        return solve_answers(res, k)

    # -- streaming lane ---------------------------------------------------

    def submit_frame(self, stream_id, frame) -> list[FrameResult] | None:
        """Queue one (N,) frame on ``stream_id``'s streaming lane.

        Frames of the same stream are answered in submission order by a
        per-stream :class:`repro_torch.stream.StreamingFilter` (delta
        filtering with cached state). Auto-flushes when ``panel_width``
        frames are pending; returns the flushed :class:`FrameResult` list
        (submission order) or None.
        """
        self._pending_frames.append((stream_id, np.asarray(frame)))
        if len(self._pending_frames) >= self.panel_width:
            return self.flush_frames()
        return None

    def flush_frames(self) -> list[FrameResult] | None:
        """Answer all pending frames now, in submission order.

        Per-frame latency and halo-words accounting accumulate on the
        engine (``frames_served``, ``stream_words``,
        ``stream_latency_s``).
        """
        if not self._pending_frames:
            return None
        results: list[FrameResult] = []
        for stream_id, frame in self._pending_frames:
            lane = self._streams.get(stream_id)
            if lane is None:
                lane = StreamingFilter(
                    self.filt,
                    backend=self.backend,
                    opts=self.opts,
                    device=self.device,
                    **self.stream_opts,
                )
                self._streams[stream_id] = lane
            res = lane.push(frame)
            results.append(res)
            self.frames_served += 1
            self.stream_words += res.words
            self.stream_latency_s += res.latency_s
        self._pending_frames.clear()
        return results

    def _pack(self, pending: list[np.ndarray]) -> tuple[np.ndarray, int]:
        """Stack pending (N,) requests into a fixed-width (N, F) panel."""
        k = len(pending)
        panel = np.stack(pending, axis=1)  # (N, k)
        if panel.dtype == np.float64:  # host inputs default to f64
            panel = panel.astype(np.float32)
        if k < self.panel_width:
            panel = np.pad(panel, ((0, 0), (0, self.panel_width - k)))
        return panel, k


@dataclasses.dataclass
class _LassoPanelSolver:
    """Callable ``panel -> SolveResult`` for the engine's solve lane.

    ``backend=None`` means "not yet bound": :class:`GraphFilterEngine`
    fills it with its own backend at construction so the apply and solve
    lanes agree; standalone use falls back to ``"bsr"``.
    """

    filt: GraphFilter
    method: str
    mu: Any
    step: float | None
    n_iters: int
    tol: float | None
    backend: str | None
    opts: dict

    def __call__(self, panel: torch.Tensor) -> SolveResult:
        problem = LassoProblem(filt=self.filt, y=panel, mu=self.mu, step=self.step)
        return solve_problem(
            problem,
            method=self.method,
            n_iters=self.n_iters,
            tol=self.tol,
            backend=self.backend or "bsr",
            **self.opts,
        )


def lasso_panel_solver(
    filt: GraphFilter,
    *,
    method: str = "fista",
    mu=1.0,
    step: float | None = None,
    n_iters: int = 40,
    tol: float | None = None,
    backend: str | None = None,
    **opts,
) -> Callable[[torch.Tensor], SolveResult]:
    """Build a panel solver for :class:`GraphFilterEngine`'s solve lane.

    Returns ``panel -> SolveResult`` running SGWT-lasso denoising
    (:class:`repro_torch.solvers.LassoProblem`) over the whole (N, F)
    panel with one ``method`` solve. Leave ``backend=None`` to inherit the
    owning engine's backend (set it explicitly only to make the lanes
    deliberately diverge). The async engine records a fixed-budget spec
    (``tol=None``) on a ``traceable`` backend as one program per width
    bucket.
    """
    return _LassoPanelSolver(
        filt=filt,
        method=method,
        mu=mu,
        step=step,
        n_iters=n_iters,
        tol=tol,
        backend=backend,
        opts=opts,
    )
