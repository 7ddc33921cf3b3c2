"""``GraphFilter`` — the entry point for Chebyshev-approximated unions of
graph Fourier multipliers (paper eqs. 8-11), backend-dispatched.

Mirrors ``repro/filters/api.py``::

    filt = GraphFilter.from_multipliers(bank, order=20, graph=g)
    out  = filt.apply(f, backend="bsr")      # (eta,) + f.shape
    back = filt.adjoint(out)                 # f.shape
    gram = filt.gram(f)                      # Phi~* Phi~ f, one 2M filter

A filter may also be built over an ordered tuple of commuting shift
operators (arXiv:2003.11152 joint polynomials, e.g. a time-vertex product
of a sensor Laplacian and a temporal Laplacian)::

    filt = GraphFilter.from_shifts([g_sensor, g_time], joint_coeffs)
    out  = filt.apply(f, backend="halo")     # per-shift halo plans

Multi-shift filters run on the backends that declare ``multi_shift``
(``dense``, ``bsr``, ``halo``). Signals are tensors; a non-tensor signal
is placed on the bound graph's device. ``apply_sparse`` is the streaming
layer's delta path, ``panel_program`` the serving layer's fixed-shape
program (one recorded CUDA graph per panel shape on the card, see
:class:`CudaGraphProgram`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import chebyshev
from repro_torch.core.graph import SensorGraph
from repro_torch.device import pinned_uploads, resolve_device, upload
from repro_torch.filters import registry
from repro_torch.kernels import cheb_bsr
from repro_torch.telemetry import span

__all__ = [
    "CudaGraphProgram",
    "GraphFilter",
    "bucket_size",
    "gather_reach",
    "shift_matvec_counts",
]

Multiplier = Callable[[np.ndarray], np.ndarray]

_BUCKET_FLOOR = 32


def bucket_size(n: int, cap: int | None = None, *, floor: int = _BUCKET_FLOOR) -> int:
    """Round ``n`` up to a power-of-two bucket (optionally capped).

    The bucket set is ``{floor * 2**k} ∪ {cap}``: ``n > cap`` returns
    ``cap`` exactly, a non-power-of-two ``cap`` is returned verbatim when
    the ladder crosses it, and ``cap < floor`` returns ``cap``.
    """
    if n < 0:
        raise ValueError(f"bucket_size needs n >= 0, got {n}")
    if floor < 1:
        raise ValueError(f"bucket_size needs floor >= 1, got {floor}")
    if cap is not None and cap < 1:
        raise ValueError(f"bucket_size needs cap >= 1, got {cap}")
    b = floor
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def gather_reach(lap: torch.Tensor, idx, b: int, *rows: torch.Tensor):
    """Restrict to a reach R on ``lap``'s device, padded to bucket ``b``.

    Uploads the reach's host indices ``idx`` once, gathers ``L[R, R]``
    into a zero (b, b) matrix and each of ``rows`` (leading axis N) into
    zero (b, ...) rows. Zero padding is a fixed point of the recurrence,
    so slicing ``[:len(idx)]`` off a restricted result is exact. Returns
    ``(idx_t, lap_sub, *row_subs)``.
    """
    idx_t = upload(np.asarray(idx, dtype=np.int64), lap.device)
    k = idx_t.shape[0]
    lap_sub = lap.new_zeros((b, b))
    lap_sub[:k, :k] = lap[idx_t[:, None], idx_t]
    subs = []
    for x in rows:
        sub = x.new_zeros((b,) + x.shape[1:])
        sub[:k] = x[idx_t]
        subs.append(sub)
    return (idx_t, lap_sub, *subs)


def shift_matvec_counts(orders: Sequence[int]) -> tuple[int, ...]:
    """Per-shift matvec counts of one joint apply:
    ``M_r * prod_{s<r} (M_s + 1)`` (just ``(M,)`` for one shift)."""
    counts: list[int] = []
    prefix = 1
    for m in orders:
        counts.append(int(m) * prefix)
        prefix *= int(m) + 1
    return tuple(counts)


def _map_tensors(fn, out):
    """``fn`` over a tensor or each tensor of a tuple."""
    if isinstance(out, tuple):
        return tuple(fn(t) for t in out)
    return fn(out)


class CudaGraphProgram:
    """A fixed-shape device program: ``fn`` recorded once as a
    ``torch.cuda.CUDAGraph`` and replayed on every call.

    This is the torch meaning of the reference's compiled panel program
    (one ``jax.jit`` per panel bucket). The program owns a static input
    of the shape its first call gives it and refuses any other shape, so
    one program holds one graph and one miss of the serving cache is one
    capture.

    * First call: ``fn`` runs once eagerly on a side stream (the warm-up:
      it fills the once-per-content coefficient uploads, ``cached_upload``,
      and the kernels' tiling choice, so nothing inside the recorded
      region copies from the host), then ``fn`` is recorded, then replayed.
    * Every call copies the caller's panel (a tensor on the program's
      device) into the static input and replays the graph.
    * ``donate=True``: the caller gives up the returned tensor(s), which
      are the program's static output, overwritten by the next call.
      ``donate=False`` returns clones, storage of their own.

    Launch counts: the kernel wrappers count their launches in Python
    (``kernels.cheb_bsr.launch_counts``) and a replay runs no Python. The
    capture records how far the counts moved while ``fn`` was recorded
    (restoring them, since nothing ran), and each replay adds that amount
    (``add_launches``), so the counts stay exact launch counts.

    Memory: the graph reads by address what ``fn`` read during the
    capture. The program keeps the static input and output, and every
    once-per-content upload the capture touched (``pinned_uploads``), so
    no cache eviction can hand memory the graph reads back to the
    allocator. Backend state lives on the filter, which ``fn`` holds.

    A capture that fails raises, with the graph discarded; nothing falls
    back to an eager call. The union kernel's cooperative launch
    (``cudaLaunchCooperativeKernel``, for its ``grid.sync()``) is
    recorded as a cooperative kernel node.

    Attributes
    ----------
    captures, replays : int
        Graphs recorded (0 or 1) and replays run.
    graph : torch.cuda.CUDAGraph or None
        The recorded graph. It keeps its ``cudaGraph_t``
        (``keep_graph=True``), so ``graph.raw_cuda_graph()`` gives the
        nodes a replay launches, to be read with the driver's graph API.
    launches_per_replay : tuple of int
        Kernel launches one replay makes, ordered as
        ``kernels.cheb_bsr.launch_counts`` (union, step, adjoint).
    """

    def __init__(self, fn: Callable[[torch.Tensor], Any], device, *, donate: bool = False):
        self.fn = fn
        if torch.device(device).type != "cuda":
            raise ValueError(f"a CUDA graph program needs a CUDA device, got {device}")
        self.device = resolve_device(device)
        self.donate = bool(donate)
        self.captures = 0
        self.replays = 0
        self.launches_per_replay = (0,) * len(cheb_bsr.launch_counts())
        self._graph: torch.cuda.CUDAGraph | None = None
        self._static_in: torch.Tensor | None = None
        self._static_out: Any = None
        self._pinned: tuple[torch.Tensor, ...] = ()

    def _record(self, panel: torch.Tensor) -> None:
        static_in = torch.empty_like(panel, memory_format=torch.contiguous_format)
        static_in.copy_(panel)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn(static_in)  # warm-up: real launches, counted as such
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = cheb_bsr.launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with pinned_uploads() as held, torch.cuda.graph(graph):
                static_out = self.fn(static_in)
            graph.instantiate()
        finally:
            moved = tuple(a - b for a, b in zip(cheb_bsr.launch_counts(), before))
            cheb_bsr.add_launches(tuple(-m for m in moved))  # recording launches nothing
        self._graph, self._static_in, self._static_out = graph, static_in, static_out
        self._pinned = tuple(held.values())
        self.launches_per_replay = moved
        self.captures += 1

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        return self._graph

    def __call__(self, panel: torch.Tensor):
        if not isinstance(panel, torch.Tensor) or panel.device != self.device:
            where = panel.device if isinstance(panel, torch.Tensor) else type(panel).__name__
            raise ValueError(f"the program takes tensors on {self.device}, got {where}")
        if self._graph is None:
            self._record(panel)
        elif panel.shape != self._static_in.shape or panel.dtype != self._static_in.dtype:
            raise ValueError(
                f"the program was recorded for {tuple(self._static_in.shape)} "
                f"{self._static_in.dtype}, got {tuple(panel.shape)} {panel.dtype}"
            )
        else:
            self._static_in.copy_(panel)
        self._graph.replay()
        self.replays += 1
        cheb_bsr.add_launches(self.launches_per_replay)
        if self.donate:
            return self._static_out
        return _map_tensors(torch.clone, self._static_out)


@dataclasses.dataclass(frozen=True, eq=False)
class GraphFilter:
    """A Chebyshev-approximated union of graph Fourier multipliers.

    Compares and hashes by identity. Carries the spectral description
    only; backend operands (dense Laplacian, Block-ELL tiles) are built
    lazily per backend and cached on the filter.

    Parameters
    ----------
    coeffs : numpy.ndarray
        (eta, M+1) float64 Chebyshev coefficients, paper eq. (8)
        convention.
    lmax : float
        Spectrum upper bound the polynomials are shifted to.
    gram_coeffs : numpy.ndarray
        (2M+1,) coefficients of ``Phi~* Phi~`` (Sec. IV-C); the
        (2M_1+1, ..., 2M_R+1) joint tensor for multi-shift filters.
    graph : SensorGraph, optional
        The bound (first-shift) graph; every backend except ``"matvec"``
        needs one.
    multipliers : tuple of callables, optional
        The multiplier bank the coefficients were expanded from.
    shifts : tuple of SensorGraph, optional
        The ordered shift tuple of a multi-shift filter (``shifts[0] is
        graph``); None on single-shift filters.
    lmaxes : tuple of float, optional
        Per-shift spectrum bounds (``lmaxes[0] == lmax``); None on
        single-shift filters.
    """

    coeffs: np.ndarray
    lmax: float
    gram_coeffs: np.ndarray
    graph: SensorGraph | None = None
    multipliers: tuple[Multiplier, ...] | None = None
    shifts: tuple[SensorGraph, ...] | None = None
    lmaxes: tuple[float, ...] | None = None
    _states: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_multipliers(
        cls,
        multipliers: Sequence[Multiplier],
        order: int,
        *,
        graph: SensorGraph | None = None,
        lmax: float | None = None,
        quad_points: int | None = None,
    ) -> "GraphFilter":
        """Expand a multiplier bank to Chebyshev coefficients (eq. 8).

        When ``lmax`` is None the bound graph's Anderson--Morley bound is
        used.
        """
        if lmax is None:
            if graph is None:
                raise ValueError("need either graph= or lmax=")
            lmax = float(graph.lmax_bound())
        c = chebyshev.cheb_coefficients(multipliers, order, lmax, quad_points)
        return cls(
            coeffs=c,
            lmax=float(lmax),
            gram_coeffs=chebyshev.gram_coefficients(c),
            graph=graph,
            multipliers=tuple(multipliers),
        )

    @classmethod
    def from_coefficients(
        cls,
        coeffs: np.ndarray,
        lmax: float,
        *,
        graph: SensorGraph | None = None,
    ) -> "GraphFilter":
        """Wrap precomputed (eta, M+1) coefficients in a filter."""
        c = np.atleast_2d(np.asarray(coeffs, dtype=np.float64))
        return cls(
            coeffs=c,
            lmax=float(lmax),
            gram_coeffs=chebyshev.gram_coefficients(c),
            graph=graph,
        )

    @classmethod
    def from_shifts(
        cls,
        shifts: Sequence[SensorGraph],
        coeffs: np.ndarray,
        *,
        lmaxes: Sequence[float] | None = None,
    ) -> "GraphFilter":
        """Build a joint polynomial filter over an ordered shift tuple.

        The shifts must commute (e.g. ``L_G (x) I`` and ``I (x) L_T`` of a
        time-vertex product) and act on one vertex set: every graph has
        the product graph's vertex count, its adjacency holding that
        shift's edges only, so each shift has its own halo plan on the
        distributed backends.

        Parameters
        ----------
        shifts : sequence of SensorGraph
            R graphs over the same vertex set.
        coeffs : numpy.ndarray
            Joint (eta, M_1+1, ..., M_R+1) coefficients (an (M_1+1, ...,
            M_R+1) tensor is promoted to eta = 1); see
            ``chebyshev.separable_joint_coefficients``.
        lmaxes : sequence of float, optional
            Per-shift spectrum bounds; default each graph's
            Anderson--Morley ``lmax_bound()``.
        """
        shifts = tuple(shifts)
        if not shifts:
            raise ValueError("from_shifts needs at least one shift")
        n = shifts[0].n_vertices
        for r, g in enumerate(shifts):
            if g.n_vertices != n:
                raise ValueError(
                    f"shift {r} has {g.n_vertices} vertices, shift 0 has {n};"
                    " all shifts act on the same product vertex set"
                )
        c = np.asarray(coeffs, dtype=np.float64)
        if c.ndim == len(shifts):
            c = c[np.newaxis]
        if c.ndim != len(shifts) + 1:
            raise ValueError(
                f"joint coeffs for {len(shifts)} shifts must have ndim "
                f"{len(shifts) + 1} (eta leading), got shape {c.shape}"
            )
        if lmaxes is None:
            lmaxes = tuple(float(g.lmax_bound()) for g in shifts)
        else:
            lmaxes = tuple(float(v) for v in lmaxes)
            if len(lmaxes) != len(shifts):
                raise ValueError(f"{len(lmaxes)} lmaxes for {len(shifts)} shifts")
        return cls(
            coeffs=c,
            lmax=lmaxes[0],
            gram_coeffs=chebyshev.joint_gram_coefficients(c),
            graph=shifts[0],
            shifts=shifts,
            lmaxes=lmaxes,
        )

    def bind(self, graph: SensorGraph) -> "GraphFilter":
        """Return a copy bound to ``graph`` (backend states reset).
        Single-shift only: rebuild a multi-shift filter with
        :meth:`from_shifts`."""
        if self.n_shifts > 1:
            raise ValueError(
                "bind() is single-shift; rebuild multi-shift filters with "
                "GraphFilter.from_shifts"
            )
        return dataclasses.replace(self, graph=graph, _states={})

    # -- introspection ---------------------------------------------------

    @property
    def eta(self) -> int:
        """Number of multipliers in the union."""
        return self.coeffs.shape[0]

    @property
    def n_shifts(self) -> int:
        """Number of shift operators (1 for single-shift filters)."""
        return self.coeffs.ndim - 1

    @property
    def order(self) -> int:
        """Chebyshev truncation order M (single-shift filters only)."""
        if self.n_shifts > 1:
            raise ValueError(
                f"multi-shift filter has per-shift orders {self.orders}; "
                "use .orders"
            )
        return self.coeffs.shape[1] - 1

    @property
    def orders(self) -> tuple[int, ...]:
        """Per-shift truncation orders (M_1, ..., M_R)."""
        return tuple(m - 1 for m in self.coeffs.shape[1:])

    @property
    def shift_graphs(self) -> tuple[SensorGraph | None, ...]:
        """The ordered shift tuple ((graph,) for single-shift filters)."""
        return self.shifts if self.shifts is not None else (self.graph,)

    @property
    def shift_lmaxes(self) -> tuple[float, ...]:
        """Per-shift spectrum bounds ((lmax,) for single-shift filters)."""
        return self.lmaxes if self.lmaxes is not None else (self.lmax,)

    def operator_norm_bound(self) -> float:
        """Upper bound on ``||Phi~||^2 = max_x sum_j p_j(x)^2`` over the
        shifted domain; multi-shift filters maximize over the tensor grid
        of ``max(64, round(8192^(1/R)))`` points per axis."""
        if self.n_shifts == 1:
            x = np.linspace(0.0, self.lmax, 8192)
            vals = np.atleast_2d(chebyshev.cheb_eval(self.coeffs, x, self.lmax))
        else:
            pts = max(64, int(round(8192 ** (1.0 / self.n_shifts))))
            xs = [np.linspace(0.0, lm, pts) for lm in self.shift_lmaxes]
            vals = chebyshev.cheb_eval_joint(self.coeffs, xs, self.shift_lmaxes)
            vals = vals.reshape(self.eta, -1)
        return float(np.max(np.sum(vals**2, axis=0)))

    # -- backend dispatch ------------------------------------------------

    def _backend(self, name: str) -> registry.FilterBackend:
        """Resolve a backend and enforce this filter's capability needs."""
        be = registry.get_backend(name)
        if self.n_shifts > 1:
            registry.require_capability(be, "multi_shift")
        return be

    def _backend_state(self, be: registry.FilterBackend, opts: dict) -> Any:
        # Backends that share prepared operands (halo and allgather use
        # the same partition plan) declare a common ``state_key``.
        key = (getattr(be, "state_key", be.name),) + tuple(
            sorted((k, v) for k, v in opts.items() if k in be.prepare_opts)
        )
        if key not in self._states:
            self._states[key] = be.prepare(self, **opts)
        return self._states[key]

    def prepare_backend(self, backend: str = "dense", **opts) -> Any:
        """Eagerly build (and cache) ``backend``'s prepared state, and
        return it (for ``bsr``, its ``.bell`` holds the Block-ELL operands)."""
        return self._backend_state(self._backend(backend), opts)

    def _signal(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        if self.graph is None:
            raise TypeError("pass a tensor signal to a filter with no bound graph")
        return torch.as_tensor(np.asarray(x), device=self.graph.device).to(torch.float32)

    def apply(self, f, *, backend: str = "dense", **opts) -> torch.Tensor:
        """Apply the union ``Phi~ f`` through one shared recurrence.

        Parameters
        ----------
        f : torch.Tensor
            (N,) or (N, F) signal(s).
        backend : str
            ``dense``, ``bsr``, ``halo``, ``allgather``, ``grid`` or
            ``matvec``. Multi-shift filters need a backend declaring the
            ``multi_shift`` capability (``dense``, ``bsr``, ``halo``).
        **opts
            Backend options (``block_size=``, ``fuse=``, ``f_tile=``,
            ``krylov_dtype=`` for ``bsr``; ``mesh=``, ``n_parts=`` for the
            distributed backends, ``overlap=`` for ``halo``, ``depth=``
            for ``grid``; ``matvec=`` for ``matvec``).

        Returns
        -------
        torch.Tensor
            (eta,) + f.shape stacked outputs.
        """
        be = self._backend(backend)
        f = self._signal(f)
        with span("filter.apply", device=True) as sp:
            if sp:
                sp.note(backend=backend, shape=tuple(f.shape))
            return be.apply(self, self._backend_state(be, opts), f, **opts)

    def apply_panel(
        self, panel, *, backend: str = "dense", width: int | None = None, **opts
    ) -> torch.Tensor:
        """Apply to an (N, F) panel zero-padded to a bucketed width (next
        power of two, floor 8, unless ``width`` is given) and sliced back.
        Zero columns are exact pass-throughs, so the output equals
        ``apply(panel)``."""
        f = self._signal(panel)
        if f.ndim != 2:
            raise ValueError(f"apply_panel wants an (N, F) panel, got {tuple(f.shape)}")
        k = f.shape[1]
        b = bucket_size(k, floor=8) if width is None else int(width)
        if b < k:
            raise ValueError(f"width={b} narrower than the panel's F={k}")
        if b > k:
            f = F.pad(f, (0, b - k))
        out = self.apply(f, backend=backend, **opts)
        return out[:, :, :k]

    def panel_program(
        self, *, backend: str = "dense", coeffs=None, donate: bool = False, **opts
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Build a reusable fixed-shape apply program for a panel lane.

        Returns ``panel (N, F) -> (eta, N, F)`` with the backend state
        prepared eagerly. On a backend declaring the ``traceable``
        capability and a filter whose graph is on a CUDA device, the
        program is a :class:`CudaGraphProgram`: its first call warms up,
        records the whole apply as one CUDA graph and replays it; every
        later call of the same shape is one replay (the reference wraps
        the apply in one ``jax.jit``). Otherwise (the CPU, or a backend
        that stages host transfers) it is the plain prepared closure.

        ``donate=True``: the caller gives up the returned tensor, which
        the next call overwrites (the reference donates the panel buffer
        to XLA); the serving engine copies each answer to the host at
        once. Callers that keep the output must leave the default, which
        returns storage of its own.
        """
        be = self._backend(backend)
        state = self._backend_state(be, opts)
        c = coeffs

        def run(panel: torch.Tensor) -> torch.Tensor:
            return be.apply(self, state, panel, coeffs=c, **opts)

        if (be.capabilities.traceable and self.graph is not None
                and self.graph.device.type == "cuda"):
            return CudaGraphProgram(run, self.graph.device, donate=donate)
        return run

    def apply_sparse(self, delta, support, *, backend: str = "dense", **opts) -> torch.Tensor:
        """Apply ``Phi~`` to a signal supported on a sparse vertex set.

        When ``delta`` is nonzero only on ``support``, the degree-M
        recurrence touches only the M-hop neighbourhood of that set, so
        backends declaring ``sparse_input`` (``dense``) run it on the
        induced submatrix. Backends without the capability, and
        multi-shift filters (whose reach spans several edge sets), fall
        back to a full ``apply``: the same output, no savings.

        Parameters
        ----------
        delta : torch.Tensor
            (N,) or (N, F) signal, zero outside ``support``.
        support : array-like
            (N,) boolean mask (or index array) of the nonzero vertices.
        **opts
            Backend options; ``reach=`` passes a precomputed (N,) host
            boolean M-hop mask (the streaming layer walks it anyway).

        Returns
        -------
        torch.Tensor
            (eta,) + delta.shape, equal to ``apply(delta)`` up to float
            tolerance, zero outside the M-hop reach of ``support``.
        """
        be = self._backend(backend)
        if not be.capabilities.sparse_input or self.n_shifts > 1:
            return self.apply(delta, backend=backend, **opts)
        state = self._backend_state(be, opts)
        return be.apply_sparse(self, state, self._signal(delta), support, **opts)

    def adjoint(self, a, *, backend: str = "dense", **opts) -> torch.Tensor:
        """Apply the adjoint ``Phi~* a`` (paper eq. 13); ``a`` is
        (eta,) + signal.shape, the result signal.shape."""
        be = self._backend(backend)
        a = self._signal(a)
        with span("filter.adjoint", device=True) as sp:
            if sp:
                sp.note(backend=backend, shape=tuple(a.shape))
            return be.adjoint(self, self._backend_state(be, opts), a, **opts)

    def apply_series(self, f, series: np.ndarray, *, backend: str = "dense", **opts):
        """Apply one polynomial ``p(S_1..S_R) f`` in this filter's shifts,
        given by its (M'+1,) series, or an (M'_1+1, ..., M'_R+1) joint
        tensor for a multi-shift filter (half-first convention), reusing
        the prepared backend state. ``gram`` and the Chebyshev inverse
        preconditioner run through it."""
        c = np.asarray(series, dtype=np.float64)
        if c.ndim != self.n_shifts:
            raise ValueError(
                f"series for a {self.n_shifts}-shift filter must have ndim "
                f"{self.n_shifts}, got shape {c.shape}"
            )
        be = self._backend(backend)
        state = self._backend_state(be, opts)
        return be.apply(self, state, self._signal(f), coeffs=c[np.newaxis], **opts)[0]

    def gram(self, f, *, backend: str = "dense", **opts) -> torch.Tensor:
        """``Phi~* Phi~ f`` as a single degree-2M filter (Sec. IV-C)."""
        return self.apply_series(f, self.gram_coeffs, backend=backend, **opts)

    def messages_per_apply(
        self,
        order: int | None = None,
        *,
        orders: Sequence[int] | None = None,
        backend: str = "dense",
        **opts,
    ) -> int:
        """Scalar words exchanged between ranks per ``Phi~ f`` of one
        (N,) signal: 0 on the single-device backends, the backend's
        communication model on ``halo``, ``allgather`` and ``grid``. On
        ``halo`` a multi-shift filter costs ``sum_r count_r *
        halo_words_r`` with ``count_r = M_r * prod_{s<r}(M_s + 1)``.

        ``order`` is a single-shift filter's M (default its order; the
        solvers pass ``2M`` for the gram); ``orders`` the per-shift orders
        (default ``self.orders``). Pass one or neither."""
        if order is not None and orders is not None:
            raise ValueError("pass order= or orders=, not both")
        if orders is None:
            if order is not None:
                if self.n_shifts > 1:
                    raise ValueError(
                        "multi-shift filter: pass per-shift orders= "
                        "instead of a scalar order="
                    )
                orders = (int(order),)
            else:
                orders = self.orders
        elif len(orders) != self.n_shifts:
            raise ValueError(f"{len(orders)} orders for {self.n_shifts} shifts")
        be = self._backend(backend)
        state = self._backend_state(be, opts)
        return be.messages_per_apply(self, state, shift_matvec_counts(orders))
