"""Train-step builders and the host-side training loop.

Mirrors ``repro/train/trainer.py``.

``make_train_step``        -- one device: gradients of the batch-mean loss
                              (``torch.autograd`` of ``models.lm.loss_fn``),
                              accumulated over microbatches, then AdamW.
``make_gossip_train_step`` -- the paper's technique as the gradient-sync
                              collective: per-rank gradients averaged by
                              Chebyshev gossip over a mesh's ring
                              (``core.gossip``), in the serial, bucketed or
                              delay-slot schedule.
``make_barrier_train_step`` / ``make_local_sgd_train_step`` -- the exact
                              all-reduce reference and local SGD on the same
                              footing.
``Trainer``                -- loop with deterministic data, async
                              checkpointing and restart from a checkpoint.

Where the reference runs a step under ``shard_map`` over the ``data``
axis, the port takes a mesh (``core.collectives``): params, optimiser
state and gradients carry a leading rank axis of ``mesh.local_ranks``
(``replicate`` makes such a tree), rank ``r`` takes rows ``[r B/P, (r+1)
B/P)`` of the global batch as ``P(data)`` splits it, and each rank's
gradient is its own ``torch.autograd.grad`` of the loss on its rows. The
``pmean`` s are ``gossip.pair_allreduce_mean``. Each rank clips by its own
gradient norm, as inside ``shard_map`` (``optim.adamw_update`` reads the
rank axis from the state's ``step``).

Every step takes ``donate=``: ``True`` updates params and optimiser state
in place (``launch.donation.jit_train_step``), ``False`` leaves them as
they were. Steps are eager: no compilation and no CUDA graph.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core import gossip
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim import AdamWConfig, adamw_update, adamw_update_
from repro_torch.train.buckets import build_bucket_plan, pack_buckets, unpack_buckets
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["make_train_step", "make_gossip_train_step", "make_barrier_train_step",
           "make_local_sgd_train_step", "Trainer", "value_and_grad", "replicate", "replica",
           "HOST_REPLICA"]

# The replica a host read of the reference's replicated ``shard_map``
# outputs returns (``out_specs=P()`` with ``check_vma=False`` lets the
# replicas drift): the first rank's, pinned by
# ``tests/test_torch_train_gossip.py``. Metrics of the stacked steps and
# the ``Trainer``'s checkpoints of a stacked state read it.
HOST_REPLICA = 0


def value_and_grad(loss_fn: Callable, params, batch) -> tuple[torch.Tensor, dict, Any]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: ``jax.value_and_grad(..., has_aux=True)``'s torch form.
    The gradient tree has the params' structure and dtypes (zeros for a
    leaf the loss does not reach); ``params`` are not modified."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        diff = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(treedef.unflatten(diff), batch)
        grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, treedef.unflatten(list(grads))


def replicate(tree, n: int):
    """``tree`` with every leaf stacked ``n`` times on a new leading axis
    (contiguous copies: the replicas may drift)."""
    return tree_map(lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape)).contiguous(), tree)


def replica(tree, r: int = HOST_REPLICA):
    """Rank ``r``'s view of a stacked tree (the inverse of ``replicate``)."""
    return tree_map(lambda t: t[r], tree)


def _microbatches(batch: dict, n_micro: int, dim: int) -> list[dict]:
    """``n_micro`` consecutive row blocks of ``batch`` along ``dim``."""
    def split(x):
        return x.reshape(x.shape[:dim] + (n_micro, x.shape[dim] // n_micro) + x.shape[dim + 1:])

    parts = tree_map(split, batch)
    return [tree_map(lambda x: x.select(dim, m), parts) for m in range(n_micro)]


def _accumulate_grads(vg: Callable, params, batch, n_micro: int, dim: int = 0):
    """Mean loss and grads over ``n_micro`` sequential microbatches (the
    activation-memory lever): grads accumulate in f32, are divided by
    ``n_micro`` and cast to the params' dtypes. ``vg(params, mb) ->
    (loss, grads)``; microbatches split the batch along ``dim`` (1 on a
    stacked batch, whose axis 0 is the rank). With one microbatch the
    grads stay in the params' dtypes."""
    if n_micro == 1:
        loss, grads = vg(params, batch)
        return loss, {"ce": loss}, grads
    flat_p, treedef = tree_flatten(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat_p]
    loss_acc = None
    for mb in _microbatches(batch, n_micro, dim):
        loss, grads = vg(params, mb)
        for a, g in zip(acc, tree_leaves(grads)):
            a += g
        del grads
        loss_acc = loss.float() if loss_acc is None else loss_acc + loss
    out = []
    for i, p in enumerate(flat_p):
        a, acc[i] = acc[i], None  # free each f32 sum as its cast is made
        a /= n_micro
        out.append(a.to(p.dtype))
    loss = loss_acc / n_micro
    return loss, {"ce": loss}, treedef.unflatten(out)


def _accumulate_grads_overlap(vg: Callable, params, batch, n_micro: int, sync: Callable,
                              dim: int = 0):
    """Grad accumulation in the gossip *delay-slot* schedule: after the
    backward of microbatch ``m`` comes the sync of microbatch ``m-1``'s
    raw f32 grads, a chain with no data dependence on the backward (in
    the reference the compiler may fly its exchanges under that backward;
    here, eager on one stream, the two run in turn); the last
    microbatch's sync is the epilogue.

    Gossip is linear, so ``mean_m sync(g_m) == sync(mean_m g_m)`` up to
    f32 re-association; the price is ``n_micro`` syncs per step.
    ``sync(tree, salt)`` takes the microbatch index as its salt.
    """
    if n_micro == 1:
        loss, grads = vg(params, batch)
        return loss, {"ce": loss}, sync(grads, 0)

    def grads_of(mb):
        loss, grads = vg(params, mb)
        return loss, tree_map(lambda g: g.to(torch.float32), grads)

    mbs = _microbatches(batch, n_micro, dim)
    loss_acc, g_prev = grads_of(mbs[0])
    synced = tree_map(torch.zeros_like, g_prev)
    for m in range(1, n_micro):
        loss, g_cur = grads_of(mbs[m])
        g_prev = sync(g_prev, m)  # the delay slot: microbatch m-1's sync
        synced = tree_map(torch.add, synced, g_prev)
        loss_acc = loss_acc + loss
        g_prev = g_cur
    synced = tree_map(torch.add, synced, sync(g_prev, n_micro))
    grads = tree_map(lambda g, p: (g / n_micro).to(p.dtype), synced, params)
    loss = loss_acc / n_micro
    return loss, {"ce": loss}, grads


def _model_loss(cfg: ModelConfig, par: ParallelConfig, rules: ShardingRules | None):
    def loss_fn(p, b):
        loss, _ = lm.loss_fn(p, b, cfg, par, rules)
        return loss, {}

    return loss_fn


def _single_vg(loss_fn: Callable) -> Callable:
    def vg(params, batch):
        loss, _, grads = value_and_grad(loss_fn, params, batch)
        return loss, grads

    return vg


def _rank_vg(loss_fn: Callable) -> Callable:
    """``vg`` over a stacked tree and batch: each local rank's loss and
    grads on its own rows, stacked on the leading rank axis."""
    def vg(params, batch):
        losses, grads = [], []
        for r in range(tree_leaves(params)[0].shape[0]):
            loss, _, g = value_and_grad(loss_fn, replica(params, r), replica(batch, r))
            losses.append(loss)
            grads.append(tree_leaves(g))
        _, treedef = tree_flatten(params)
        stacked = [torch.stack(per_leaf) for per_leaf in zip(*grads)]
        return torch.stack(losses), treedef.unflatten(stacked)

    return vg


def _rank_rows(batch: dict, mesh) -> dict:
    """The global batch as the mesh's local ranks see it: ``(R, B/P,
    ...)``, rank ``r`` holding rows ``[r B/P, (r+1) B/P)`` (``P(data)``)."""
    p = mesh.n_parts

    def rows(x):
        if x.shape[0] % p:
            raise ValueError(f"global batch {x.shape[0]} does not split over {p} ranks")
        return mesh.local_rows(x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:])), 0)

    return tree_map(rows, batch)


def _update(donate: bool) -> Callable:
    return adamw_update_ if donate else adamw_update


def _host_metrics(loss, om: dict) -> dict:
    """A stacked step's metrics as the reference's host read sees them:
    the host replica's entries (the loss is the same on every rank)."""
    return {"loss": loss[HOST_REPLICA], **{k: v[HOST_REPLICA] for k, v in om.items()}}


def make_train_step(
    cfg: ModelConfig,
    par: ParallelConfig,
    optc: AdamWConfig,
    rules: ShardingRules | None = None,
) -> Callable:
    """One-device train step: ``(params, opt_state, batch, donate=False)
    -> (params, opt_state, metrics)``."""
    vg = _single_vg(_model_loss(cfg, par, rules))

    def train_step(params, opt_state, batch, donate: bool = False):
        loss, _, grads = _accumulate_grads(vg, params, batch, par.microbatches)
        params, opt_state, om = _update(donate)(params, grads, opt_state, optc)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_gossip_train_step(
    cfg: ModelConfig,
    par: ParallelConfig,
    optc: AdamWConfig,
    rules: ShardingRules | None,
    mesh,
    round_delay: Callable | None = None,
) -> Callable:
    """Decentralized-DP train step with Chebyshev-gossip gradient sync.

    Params and optimiser state are replicated per rank (``replicate``):
    each replica may drift by the consensus tolerance. Schedules
    (``ParallelConfig``):

    * ``gossip_buckets=K > 1`` packs the gradient tree into K flat
      size-balanced buckets (``train.buckets``, the plan built from one
      rank's leaves), so each round moves ``2 K`` messages instead of
      ``2 n_leaves``; the emulated delay rides on bucket 0 with
      ``delay_messages = 2 K``.
    * ``gossip_overlap=True`` with ``microbatches > 1`` is the delay-slot
      schedule (:func:`_accumulate_grads_overlap`).
    * ``gossip_payload_dtype`` / ``gossip_truncate``: bf16 exchanges and
      round truncation (``core.gossip.chebyshev_gossip_mean``).

    ``round_delay`` is the emulated-interconnect hook
    (``runtime.fault.StragglerInjector.gossip_round``), called on the host
    per local rank per round; None for production.
    """
    d = mesh.n_parts
    order = par.gossip_order or gossip.required_order(d, 1e-3)
    vg = _rank_vg(_model_loss(cfg, par, rules))

    def sync_leaves(tree, salt):
        return gossip.chebyshev_gossip_mean(
            tree, mesh, order=order, payload_dtype=par.gossip_payload_dtype,
            truncate=par.gossip_truncate, round_delay=round_delay, delay_salt=salt)

    def sync_bucketed(tree, salt):
        plan = build_bucket_plan(replica(tree, 0), par.gossip_buckets)
        flats = pack_buckets(plan, tree)
        outs = [
            gossip.chebyshev_gossip_mean(
                f, mesh, order=order, payload_dtype=par.gossip_payload_dtype,
                truncate=par.gossip_truncate, round_delay=round_delay if b == 0 else None,
                delay_salt=salt, delay_messages=2 * len(flats))
            for b, f in enumerate(flats)
        ]
        return unpack_buckets(plan, outs)

    sync = sync_bucketed if par.gossip_buckets > 1 else sync_leaves

    def train_step(params, opt_state, batch, donate: bool = False):
        rows = _rank_rows(batch, mesh)
        if par.gossip_overlap:
            loss, _, grads = _accumulate_grads_overlap(vg, params, rows, par.microbatches,
                                                       sync, dim=1)
        else:
            loss, _, grads = _accumulate_grads(vg, params, rows, par.microbatches, dim=1)
            grads = sync(grads, 0)
        params, opt_state, om = _update(donate)(params, grads, opt_state, optc)
        loss = gossip.pair_allreduce_mean(loss, mesh)
        return params, opt_state, _host_metrics(loss, om)

    return train_step


def make_barrier_train_step(
    cfg: ModelConfig,
    par: ParallelConfig,
    optc: AdamWConfig,
    rules: ShardingRules | None,
    mesh,
    barrier_delay: Callable | None = None,
) -> Callable:
    """All-reduce reference step on the same footing as the gossip step
    (replicated params, grads averaged exactly), so comparisons isolate
    the collective.

    ``barrier_delay(rank, n_phases)`` emulates the straggler cost of the
    global barrier (a ring all-reduce is ``2 (P-1)`` sequential phases):
    a host call per local rank per step, as the gossip step's
    ``round_delay`` is.
    """
    n_phases = 2 * (mesh.n_parts - 1)
    vg = _rank_vg(_model_loss(cfg, par, rules))

    def train_step(params, opt_state, batch, donate: bool = False):
        rows = _rank_rows(batch, mesh)
        loss, _, grads = _accumulate_grads(vg, params, rows, par.microbatches, dim=1)
        if barrier_delay is not None:
            for rank in mesh.rank_index().tolist():
                barrier_delay(int(rank), n_phases)
        grads = gossip.pair_allreduce_mean(grads, mesh)
        params, opt_state, om = _update(donate)(params, grads, opt_state, optc)
        loss = gossip.pair_allreduce_mean(loss, mesh)
        return params, opt_state, _host_metrics(loss, om)

    return train_step


def make_local_sgd_train_step(
    cfg: ModelConfig,
    par: ParallelConfig,
    optc: AdamWConfig,
    rules: ShardingRules | None,
    mesh,
) -> tuple[Callable, Callable]:
    """Local-SGD (bounded-staleness) training: replicas take purely local
    steps (no gradient communication) and resynchronise now and then with
    one exact parameter average.

    Returns ``(local_step, resync)``; ``resync(params)`` returns the
    averaged params. The caller decides when to call it: as in the
    reference, ``Trainer`` never does.
    """
    vg = _rank_vg(_model_loss(cfg, par, rules))

    def train_step(params, opt_state, batch, donate: bool = False):
        rows = _rank_rows(batch, mesh)
        loss, _, grads = _accumulate_grads(vg, params, rows, par.microbatches, dim=1)
        params, opt_state, om = _update(donate)(params, grads, opt_state, optc)
        loss = gossip.pair_allreduce_mean(loss, mesh)
        return params, opt_state, _host_metrics(loss, om)

    def resync(params):
        return gossip.pair_allreduce_mean(params, mesh)

    return train_step, resync


@dataclasses.dataclass
class Trainer:
    """Host-side loop: deterministic data, async checkpoints, restart.

    One loss read per step (``float(metrics["loss"])``) is the step's
    synchronisation, as in the reference. ``host_replica`` is set for a
    stacked state (the gossip, barrier and local-SGD steps): checkpoints
    then hold that replica, the one the reference's host read returns
    (``HOST_REPLICA``), in the reference's unstacked layout.
    """

    train_step: Callable
    pipeline: Any                      # SyntheticTokenPipeline-like
    ckpt: Any                          # CheckpointManager
    params: Any
    opt_state: Any
    ckpt_every: int = 50
    failure_injector: Callable[[int], None] | None = None
    straggler_monitor: Any = None      # runtime.fault.StragglerMonitor
    host_replica: int | None = None

    def _snapshot(self) -> dict:
        state = {"params": self.params, "opt": self.opt_state}
        return state if self.host_replica is None else replica(state, self.host_replica)

    def run(self, n_steps: int, start_step: int = 0) -> dict:
        step = start_step
        metrics = {}
        losses = []
        step_s = []
        t0 = time.monotonic()
        while step < n_steps:
            if self.failure_injector is not None:
                self.failure_injector(step)  # may raise WorkerFailure
            batch = self.pipeline.batch_at(step)
            ts = time.monotonic()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            losses.append(float(metrics["loss"]))  # blocks on the step
            step_s.append(time.monotonic() - ts)
            if self.straggler_monitor is not None:
                self.straggler_monitor.tick(step)
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save_async(step, self._snapshot())
        self.ckpt.wait()
        out = {
            "final_step": step,
            "losses": losses,
            "step_s": step_s,
            "wall_s": time.monotonic() - t0,
            **{k: float(v) for k, v in metrics.items()},
        }
        if self.straggler_monitor is not None:
            out["straggler_flagged"] = list(self.straggler_monitor.flagged)
        return out
