"""Chebyshev-accelerated gossip consensus on a ring of ranks.

Mirrors ``repro/core/gossip.py``. The paper's machinery turned on the
training cluster: the "sensor network" is a ring of P ranks, the "signal"
one gradient copy per rank, and the multiplier the consensus projection
``g(lambda) = 1{lambda = 0}``, approximated by the minimax (scaled
Chebyshev) polynomial

    p_M(x) = T_M((lmax + lam1 - 2 x) / (lmax - lam1)) / T_M(t0),

with ``p_M(0) = 1`` (the mean is kept exactly) and every disagreement
component shrunk by at least ``1 / T_M((lmax + lam1) / (lmax - lam1))``.
Coefficients come from eq. (8) quadrature (``core.chebyshev``) and the
polynomial is applied by the eq. (9) recurrence, its matvec the ring
Laplacian ``2x - x_left - x_right`` realised with two cyclic neighbour
exchanges per round (``mesh.ring_fwd`` / ``mesh.ring_bwd``).

Where the reference runs under ``shard_map`` with an ``axis_name``, the
port takes a mesh (``core.collectives``): every leaf carries a leading
rank axis of ``mesh.local_ranks`` (P on a ``StackedMesh``, 1 in a
``GroupMesh``). ``lax.scan`` becomes a plain loop, and the jaxpr walk of
``measured_ppermute_words`` reads the mesh's ``ring`` byte counter.

Trap: gossip's recurrence is ``(2/alpha)(L t - alpha t) - t_{k-2}``
(``repro/core/gossip.py:264``), not the kernels' ``(2/alpha) L t - 2t -
t_{k-2}``; the two round differently in bf16, and this module keeps
gossip's own.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import chebyshev
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "ring_spectrum_bounds",
    "consensus_coefficients",
    "consensus_contraction",
    "required_order",
    "ring_laplacian_matvec",
    "chebyshev_gossip_mean",
    "pair_allreduce_mean",
    "truncation_profile",
    "payload_roundoff_bound",
    "gossip_message_words",
    "gossip_message_bytes",
    "allreduce_message_words",
    "measured_ppermute_words",
]


def _torch_dtype(dtype) -> torch.dtype | None:
    """``"bfloat16"`` or a ``torch.dtype`` as a ``torch.dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def ring_spectrum_bounds(p: int) -> tuple[float, float]:
    """(lam1, lmax) of the unit-weight ring C_p Laplacian.

    Eigenvalues are ``2 - 2 cos(2 pi k / p)``; lam1 is the spectral gap
    (Fiedler value), lmax = 4 for even p.
    """
    if p < 2:
        raise ValueError("ring needs >= 2 devices")
    lam1 = 2.0 - 2.0 * math.cos(2.0 * math.pi / p)
    kmax = p // 2
    lmax = 2.0 - 2.0 * math.cos(2.0 * math.pi * kmax / p)
    return lam1, lmax


def consensus_contraction(order: int, lam1: float, lmax: float) -> float:
    """Per-application contraction of non-consensus components: 1/T_M(t0)."""
    if lmax - lam1 < 1e-12:
        # degenerate spectrum (e.g. C_3: {0, 3, 3}): p(x) = 1 - x/lam1 is
        # exact consensus in one round.
        return 0.0
    t0 = (lmax + lam1) / (lmax - lam1)
    # T_M(t0) = cosh(M * arccosh(t0)) for t0 > 1.
    return 1.0 / math.cosh(order * math.acosh(t0))


def required_order(p: int, eps: float) -> int:
    """Smallest M with contraction <= eps on a ring of p devices
    (~ sqrt(1/gap) * log(1/eps) ~ O(p log(1/eps)) rounds)."""
    lam1, lmax = ring_spectrum_bounds(p)
    for m in range(1, 64 * p):
        if consensus_contraction(m, lam1, lmax) <= eps:
            return m
    raise RuntimeError("did not reach eps")


def consensus_coefficients(order: int, lam1: float, lmax: float) -> np.ndarray:
    """Shifted-Chebyshev (paper eq. 8) coefficients of the minimax
    consensus polynomial p_M on [0, lmax], shape (1, order + 1), float64.

    p_M has degree ``order``, so quadrature with enough nodes recovers its
    shifted-basis coefficients exactly.
    """
    if lmax - lam1 < 1e-12:
        return chebyshev.cheb_coefficients(
            [lambda x: 1.0 - np.asarray(x, dtype=np.float64) / lam1],
            order, lmax, quad_points=max(4 * (order + 1), 256))
    t0 = (lmax + lam1) / (lmax - lam1)

    def cheb_t(m: int, x: np.ndarray) -> np.ndarray:
        # Numerically stable T_m for |x| possibly > 1.
        return np.where(
            np.abs(x) <= 1.0,
            np.cos(m * np.arccos(np.clip(x, -1.0, 1.0))),
            np.cosh(m * np.arccosh(np.maximum(np.abs(x), 1.0))) * np.sign(x) ** m,
        )

    denom = math.cosh(order * math.acosh(t0))

    def p_m(x):
        y = (lmax + lam1 - 2.0 * np.asarray(x, dtype=np.float64)) / (lmax - lam1)
        return cheb_t(order, y) / denom

    return chebyshev.cheb_coefficients(
        [p_m], order, lmax, quad_points=max(4 * (order + 1), 256))


def ring_laplacian_matvec(tree: Any, mesh, payload_dtype: Any | None = None) -> Any:
    """Ring-Laplacian matvec ``L x = 2 x - x_left - x_right`` on a tree
    whose leaves carry a leading rank axis of ``mesh.local_ranks``.

    ``payload_dtype`` (``"bfloat16"`` or a ``torch.dtype``) rounds only
    the *exchanged* copies; the local term and the arithmetic stay in the
    leaf dtype (bf16 payloads, f32 math), as in the reference
    (``repro/core/gossip.py:155-159``).
    """
    pdt = _torch_dtype(payload_dtype)

    def leaf(v):
        send = v if pdt is None or v.dtype == pdt else v.to(pdt)
        left = mesh.ring_fwd(send).to(v.dtype)
        right = mesh.ring_bwd(send).to(v.dtype)
        out = v * 2.0
        out -= left
        out -= right
        return out

    return tree_map(leaf, tree)


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (exact in ``dtype``),
    so a scalar operand rounds as the reference's cast constants do."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def chebyshev_gossip_mean(
    tree: Any,
    mesh,
    *,
    order: int | None = None,
    eps: float = 1e-3,
    payload_dtype: Any | None = None,
    truncate: int = 0,
    round_delay: Callable[[int, int, int], None] | None = None,
    delay_salt: Any | None = None,
    delay_messages: int | None = None,
) -> Any:
    """Approximate the mean over the mesh's ranks of ``tree`` by
    Chebyshev gossip.

    Every leaf carries a leading rank axis of ``mesh.local_ranks``; the
    result has the leaves' shapes and dtypes. ``order`` defaults to the
    smallest M whose contraction reaches ``eps``. ``payload_dtype`` rounds
    only the exchanged copies (:func:`ring_laplacian_matvec`);
    ``truncate`` drops the last ``truncate`` rounds (bias profile:
    :func:`truncation_profile`).

    ``round_delay`` is called on the host as ``(rank, round_k,
    n_messages)`` once per local rank at the start of every round, before
    that round's exchange: ``mesh.local_ranks * (order - truncate)`` calls
    per sync, ``n_messages`` being ``2 * n_leaves`` or ``delay_messages``.
    ``delay_salt`` is accepted and ignored: the reference needs it only to
    keep XLA from merging the callbacks of an outer scan, and a host loop
    merges nothing.
    """
    del delay_salt
    p = mesh.n_parts
    if p == 1:
        return tree
    if order is None:
        order = required_order(p, eps)
    if not 0 <= truncate < order:
        raise ValueError(f"truncate={truncate} must satisfy 0 <= truncate < order={order}")
    lam1, lmax = ring_spectrum_bounds(p)
    coeffs = consensus_coefficients(order, lam1, lmax)[0][: order - truncate + 1]

    leaves, treedef = tree_flatten(tree)
    dtype = leaves[0].dtype
    # The reference casts the coefficients and alpha to the leaf dtype
    # (repro/core/gossip.py:222-223) and forms 0.5 c_0 and 2/alpha there.
    c = [_scalar(ck, dtype) for ck in coeffs]
    alpha = _scalar(lmax / 2.0, dtype)
    half_c0 = _scalar(0.5 * c[0], dtype)
    two_over_alpha = _scalar(2.0 / alpha, dtype)

    ranks: list[int] = []
    if round_delay is not None:
        n_messages = 2 * len(leaves) if delay_messages is None else delay_messages
        ranks = [int(r) for r in mesh.rank_index().tolist()]

    def matvec(xs, k):
        for rank in ranks:
            round_delay(rank, k, n_messages)
        return ring_laplacian_matvec(xs, mesh, payload_dtype)  # a list in, a list out

    def shifted(lv, v):  # L t - alpha t, in place on the matvec's output
        lv -= v * alpha
        return lv

    t0 = leaves
    t1 = [(shifted(lv, v) / alpha).to(v.dtype) for lv, v in zip(matvec(t0, 0), t0)]
    acc = [(x * half_c0 + y * c[1]).to(x.dtype) for x, y in zip(t0, t1)]
    t_prev1, t_prev2 = t1, t0
    for k in range(1, len(c) - 1):
        t_k = []
        for lv, v, v2 in zip(matvec(t_prev1, k), t_prev1, t_prev2):
            t = shifted(lv, v)
            t *= two_over_alpha
            t -= v2
            t_k.append(t.to(v.dtype))
        acc = [(a + t * c[k + 1]).to(a.dtype) for a, t in zip(acc, t_k)]
        t_prev1, t_prev2 = t_k, t_prev1
    return tree_unflatten(treedef, acc)


def pair_allreduce_mean(tree: Any, mesh) -> Any:
    """Exact mean over the mesh's ranks (the reference's ``pmean``),
    from one ``all_gather`` per leaf."""

    def leaf(v):
        full = mesh.all_gather(v.reshape(v.shape[0], 1, -1))  # (R, P, n)
        return full.mean(dim=1).reshape(v.shape).to(v.dtype)

    return tree_map(leaf, tree)


def truncation_profile(
    order: int,
    truncate: int,
    lam1: float,
    lmax: float,
    grid: int = 4096,
) -> tuple[float, float]:
    """Exact bias profile ``(mean_gain, disagreement_gain)`` of the
    ``truncate``-round-truncated consensus polynomial: ``mean_gain =
    p_t(0)``, ``disagreement_gain`` the max of ``|p_t|`` over ``[lam1,
    lmax]`` on a ``grid``-point grid. ``truncate=0`` recovers ``(1.0,
    consensus_contraction(order, ...))`` up to quadrature.
    """
    if not 0 <= truncate < order:
        raise ValueError(f"truncate={truncate} must satisfy 0 <= truncate < order={order}")
    coeffs = consensus_coefficients(order, lam1, lmax)[0][: order - truncate + 1]
    mean_gain = float(chebyshev.cheb_eval(coeffs, np.array([0.0]), lmax)[0])
    xs = np.linspace(lam1, lmax, grid)
    disagreement_gain = float(np.max(np.abs(chebyshev.cheb_eval(coeffs, xs, lmax))))
    return mean_gain, disagreement_gain


def payload_roundoff_bound(order: int) -> float:
    """Relative error floor of bf16 gossip payloads, ``4 M 2^-8`` of
    ``||x||_2``: two exchanged copies rounded per round (unit roundoff
    ``2^-8``), adding at most linearly over M rounds and the coefficient
    combine (``sum |c_k| <= 2``). Loose by design."""
    return 4.0 * order * 2.0**-8


def gossip_message_words(order: int, axis_size: int, n_params: int) -> int:
    """Scalar words moved per sync across all ranks: each of the M rounds
    sends the full vector to both ring neighbours."""
    return order * 2 * axis_size * n_params


def gossip_message_bytes(order: int, axis_size: int, n_params: int,
                         payload_dtype: Any = "float32") -> int:
    """Bytes per sync across all ranks: what bf16 payloads halve."""
    dt = _torch_dtype(payload_dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    return gossip_message_words(order, axis_size, n_params) * itemsize


def allreduce_message_words(axis_size: int, n_params: int) -> int:
    """Ring all-reduce reference: 2 (P-1)/P * n per device."""
    return int(2 * (axis_size - 1) * n_params)


def measured_ppermute_words(mesh, fn: Callable, *args) -> int:
    """Words per rank that one call ``fn(*args)`` exchanges on ``mesh``'s
    ring: the growth of the mesh's ``ring`` byte counter over the call,
    in f32 words (a bf16 payload counts half a word), divided by the
    ranks the mesh holds. The reference walks the traced program's
    ``ppermute`` payloads instead (``repro/core/gossip.py:357``); both
    measure the schedule that ran, bucketing, payload dtype and
    truncation included."""
    before = mesh.bytes["ring"]
    fn(*args)
    return int(round((mesh.bytes["ring"] - before) / 4.0 / mesh.local_ranks))
