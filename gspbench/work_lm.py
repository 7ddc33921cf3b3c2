"""The work of the language-model cells' calls, from their shapes alone.

Counts never look at chunks, padding or which kernels ran, so a later
kernel (a fused absorbed-attention decode kernel, say) is held to the same
yardstick.

* One absorbed latent-attention call (``mla.absorbed_attention``): for
  ``batch * queries * heads`` query rows, ``W_UK`` into the query
  (``nope_dim * rank`` multiply-adds), scores over ``keys`` latent rows
  (``keys * (rank + rope_dim)``), the weighted sum of latents (``keys *
  rank``) and ``W_UV`` (``rank * v_dim``), two operations each; it reads
  each of a row's ``keys`` latent rows (``rank + rope_dim`` values) once,
  the queries and ``W_kv_b`` once, and writes the outputs once, in
  bfloat16. ``keys`` are the rows a query sees (its own row and those
  before it), not the cache's capacity.

The bound of a call is the larger of its operations at the bfloat16 tensor
peak and its bytes at the HBM rate.
"""

from __future__ import annotations

from gspbench import work

__all__ = ["PEAK_BF16_FLOPS", "absorbed_mla_work", "bound_seconds"]

# NVIDIA H100 SXM data sheet, dense bfloat16, at its 700 W limit.
PEAK_BF16_FLOPS = 989e12

_BF16 = 2


def absorbed_mla_work(batch: int, queries: int, keys: int, heads: int, rank: int,
                      rope_dim: int, nope_dim: int, v_dim: int) -> tuple[int, int]:
    """(operations, bytes) of one absorbed latent-attention call."""
    rows = batch * queries * heads
    flops = 2 * rows * (nope_dim * rank + keys * (rank + rope_dim) + keys * rank + rank * v_dim)
    nbytes = _BF16 * (batch * keys * (rank + rope_dim) + rows * (nope_dim + rope_dim)
                      + rows * v_dim + rank * heads * (nope_dim + v_dim))
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of a call, and which of ``operations`` and ``bytes``
    sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / work.PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
