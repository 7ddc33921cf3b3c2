"""Training pieces of the port (mirrors ``repro/train``).

Only the gradient buckets so far. The reference's package init also
imports the trainer, and with it the models (``repro/train/__init__.py``);
the port's trainer comes with its models.
"""

from repro_torch.train.buckets import BucketPlan, build_bucket_plan, pack_buckets, unpack_buckets

__all__ = ["BucketPlan", "build_bucket_plan", "pack_buckets", "unpack_buckets"]
