"""The collectives the distributed layer runs on.

The port's counterpart of ``jax.lax.all_to_all``, ``all_gather``,
``ppermute`` and ``axis_index`` under ``shard_map`` in
``repro/core/distributed.py``. Two meshes implement the same calls:

* :class:`StackedMesh` — P ranks along a leading tensor axis on one
  device; every collective is an explicit device operation over that
  axis. This is how one card (or the CPU) runs a P-rank schedule, as the
  reference's tests run theirs with vmap-as-mesh collectives.
* :class:`GroupMesh` — one rank per process of a ``torch.distributed``
  process group (gloo on the CPU, NCCL across cards).

Convention: every per-rank tensor carries a leading rank axis of size
``mesh.local_ranks`` — P on the stacked mesh, 1 in a process group — so
the local math is written once over that axis and serves both meshes.

Both meshes count their calls and the elements each rank sends to the
*other* ranks (padding included, self-sends excluded), and those
elements' bytes, per kind: ``all_to_all``, ``all_gather``, ``shift`` (one
open-ended ``ppermute``: the edge ranks receive zeros), ``ring`` (one
cyclic ``ppermute`` with pairs ``(i, (i+1) % P)`` or the reverse, the
exchange of ``repro/core/gossip.py``) and ``gather`` (assembling a result
on every rank, outside the schedules' exchanges). Summed over the
processes of a group, the element counts equal the stacked mesh's; the
call counts are per rank on both.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["StackedMesh", "GroupMesh", "default_mesh"]


class _Done:
    """A finished exchange: ``wait()`` hands back its result."""

    def __init__(self, value: torch.Tensor):
        self._value = value

    def wait(self) -> torch.Tensor:
        return self._value


class _InFlight:
    """An exchange issued with ``async_op=True``; ``wait()`` blocks on it."""

    def __init__(self, work, value: torch.Tensor):
        self._work, self._value = work, value

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._value


def _mesh_device(device) -> torch.device:
    """``resolve_device`` with a CUDA device pinned to an index, so it
    compares equal to the device of the tensors placed on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Mesh:
    """Call and element counters shared by both meshes."""

    n_parts: int
    local_ranks: int
    device: torch.device
    # Whether an exchange issued with ``async_op=True`` can be in flight
    # while the rank computes: it picks the halo backend's default
    # schedule (overlapped or serial).
    overlaps: bool

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.elements: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.calls.clear()
        self.elements.clear()
        self.bytes.clear()

    def _count(self, kind: str, elements: int, x: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.elements[kind] += int(elements)
        self.bytes[kind] += int(elements) * x.element_size()

    def _check(self, x: torch.Tensor, what: str) -> None:
        if x.shape[0] != self.local_ranks:
            raise ValueError(
                f"{what}: leading rank axis {x.shape[0]}, mesh holds {self.local_ranks}"
            )
        if x.device != self.device:
            raise ValueError(f"{what}: tensor on {x.device}, mesh on {self.device}")


class StackedMesh(_Mesh):
    """P ranks stacked along a leading tensor axis on one device.

    Parameters
    ----------
    n_parts : int
        Number of ranks P.
    device : str or torch.device, optional
        Where the stacked tensors live (default ``cuda``; raises without
        it, as every entry point of the port does).
    """

    # The exchange is a transpose on the compute stream: nothing is in
    # flight for the overlapped schedule to hide.
    overlaps = False

    def __init__(self, n_parts: int, device: str | torch.device | None = None):
        super().__init__()
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        self.n_parts = self.local_ranks = int(n_parts)
        self.device = _mesh_device(device)

    def __repr__(self) -> str:
        return f"StackedMesh(n_parts={self.n_parts}, device={self.device})"

    def rank_index(self) -> torch.Tensor:
        """(R,) rank ids of the local ranks: all P of them."""
        return torch.arange(self.n_parts, device=self.device)

    def local_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The local ranks' entries of a tensor with a full rank axis P
        at ``dim``: all of them."""
        return x

    def all_to_all(self, x: torch.Tensor, *, async_op: bool = False):
        """``(R, P, H, ...) -> (R, P, H, ...)`` with ``recv[p, q] =
        send[q, p]``: rank p's chunk q goes to rank q."""
        self._check(x, "all_to_all")
        p = self.n_parts
        self._count("all_to_all", x[0, 0].numel() * p * (p - 1), x)
        out = x.transpose(0, 1).contiguous()
        return _Done(out) if async_op else out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(R, n, ...) -> (R, P*n, ...)``: every rank gets every slab,
        in rank order."""
        self._check(x, "all_gather")
        p = self.n_parts
        self._count("all_gather", x[0].numel() * p * (p - 1), x)
        full = x.reshape((1, -1) + x.shape[2:])
        return full.expand((p,) + full.shape[1:])

    def _shift(self, x: torch.Tensor, fwd: bool) -> torch.Tensor:
        self._check(x, "shift")
        self._count("shift", x[0].numel() * (self.n_parts - 1), x)
        out = torch.zeros_like(x)
        if self.n_parts > 1:
            if fwd:
                out[1:] = x[:-1]
            else:
                out[:-1] = x[1:]
        return out

    def shift_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """``ppermute`` with pairs ``(i, i+1)``: rank i+1 receives rank
        i's block, rank 0 receives zeros."""
        return self._shift(x, fwd=True)

    def shift_bwd(self, x: torch.Tensor) -> torch.Tensor:
        """``ppermute`` with pairs ``(i+1, i)``: rank i receives rank
        i+1's block, the last rank receives zeros."""
        return self._shift(x, fwd=False)

    def _ring(self, x: torch.Tensor, step: int) -> torch.Tensor:
        self._check(x, "ring")
        p = self.n_parts
        self._count("ring", x[0].numel() * p if p > 1 else 0, x)
        return torch.roll(x, step, dims=0)

    def ring_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """``ppermute`` with pairs ``(i, (i+1) % P)``: rank i receives rank
        i-1's block, rank 0 the last rank's."""
        return self._ring(x, 1)

    def ring_bwd(self, x: torch.Tensor) -> torch.Tensor:
        """``ppermute`` with pairs ``((i+1) % P, i)``: rank i receives
        rank i+1's block, the last rank rank 0's."""
        return self._ring(x, -1)

    def gather_ranks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Assemble all P ranks along ``dim``: the stacked mesh holds
        them already."""
        return x


class GroupMesh(_Mesh):
    """One rank per process of a ``torch.distributed`` process group.

    Parameters
    ----------
    group : ProcessGroup, optional
        The group (default: the world group; ``torch.distributed`` must be
        initialised).
    device : str or torch.device, optional
        Where this rank's tensors live (default ``cuda``; pass ``"cpu"``
        for a gloo group).
    """

    local_ranks = 1
    overlaps = True

    def __init__(self, group=None, device: str | torch.device | None = None):
        super().__init__()
        if not dist.is_initialized():
            raise RuntimeError("GroupMesh needs an initialised torch.distributed process group")
        self.group = group
        self.n_parts = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = _mesh_device(device)

    def __repr__(self) -> str:
        return f"GroupMesh(rank={self.rank}/{self.n_parts}, device={self.device})"

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def rank_index(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def local_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x.narrow(dim, self.rank, 1)

    def all_to_all(self, x: torch.Tensor, *, async_op: bool = False):
        self._check(x, "all_to_all")
        if x.shape[1] != self.n_parts:
            raise ValueError(f"all_to_all: {x.shape[1]} chunks for {self.n_parts} ranks")
        self._count("all_to_all", x[0, 0].numel() * (self.n_parts - 1), x)
        send = x[0].contiguous()
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group, async_op=async_op)
        return _InFlight(work, recv[None]) if async_op else recv[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, "all_gather")
        self._count("all_gather", x[0].numel() * (self.n_parts - 1), x)
        return self._gather(x[0])[None]

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        local = local.contiguous()
        out = torch.empty((self.n_parts * local.shape[0],) + local.shape[1:],
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=self.group)
        return out

    def _shift(self, x: torch.Tensor, fwd: bool) -> torch.Tensor:
        self._check(x, "shift")
        dst = self.rank + 1 if fwd else self.rank - 1
        src = self.rank - 1 if fwd else self.rank + 1
        send = x.contiguous()
        out = torch.zeros_like(send)
        ops = []
        if 0 <= dst < self.n_parts:
            ops.append(dist.P2POp(dist.isend, send, self._peer(dst), self.group))
        if 0 <= src < self.n_parts:
            ops.append(dist.P2POp(dist.irecv, out, self._peer(src), self.group))
        self._count("shift", send.numel() if 0 <= dst < self.n_parts else 0, send)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def shift_fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, fwd=True)

    def shift_bwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, fwd=False)

    def _ring(self, x: torch.Tensor, step: int) -> torch.Tensor:
        self._check(x, "ring")
        p = self.n_parts
        send = x.contiguous()
        self._count("ring", send.numel() if p > 1 else 0, send)
        if p == 1:
            return send.clone()
        out = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self._peer((self.rank + step) % p), self.group),
               dist.P2POp(dist.irecv, out, self._peer((self.rank - step) % p), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def ring_fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, 1)

    def ring_bwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, -1)

    def gather_ranks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Assemble all P ranks along ``dim`` (size 1 here) on every rank."""
        self._count("gather", x.numel() * (self.n_parts - 1), x)
        moved = torch.movedim(x, dim, 0)
        return torch.movedim(self._gather(moved), 0, dim)


def default_mesh(n_parts: int | None, device: str | torch.device | None):
    """The mesh a backend prepares when the caller gives none: a
    :class:`GroupMesh` over the world when ``torch.distributed`` is
    initialised and ``n_parts`` is not given, else
    ``StackedMesh(n_parts or 1)`` on ``device``."""
    if n_parts is None and dist.is_available() and dist.is_initialized():
        return GroupMesh(device=device)
    return StackedMesh(n_parts or 1, device)
