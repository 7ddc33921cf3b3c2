"""Training of the port (mirrors ``repro/train``): the gradient buckets,
the train-step builders and the host-side ``Trainer``; beside them the
port's helpers for stacked (per-rank) state, ``replicate`` and
``replica``, and ``value_and_grad``."""

from repro_torch.train.buckets import BucketPlan, build_bucket_plan, pack_buckets, unpack_buckets
from repro_torch.train.trainer import (
    HOST_REPLICA,
    Trainer,
    make_barrier_train_step,
    make_gossip_train_step,
    make_local_sgd_train_step,
    make_train_step,
    replica,
    replicate,
    value_and_grad,
)

__all__ = ["Trainer", "make_barrier_train_step", "make_gossip_train_step",
           "make_local_sgd_train_step", "make_train_step",
           "BucketPlan", "build_bucket_plan", "pack_buckets", "unpack_buckets",
           "HOST_REPLICA", "replica", "replicate", "value_and_grad"]
