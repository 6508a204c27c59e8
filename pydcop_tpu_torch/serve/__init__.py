"""Many-tenant batched solving on the card.

Counterpart of ``pydcop_tpu/serve/`` (its router is not ported):

- ``serve.bucket``: shape buckets, every padded ``DeviceDCOP`` dimension
  rounded up to a power of two, so problems of one size class share a
  batch and its captured graphs;
- ``serve.batch``: the batch engine, K bucket-padded problems solved as
  one (``algorithms.base.run_batch``: the engine mapped over an instance
  axis, each kernel one launch for the batch), each tenant's result the
  bits of its solo ``solve_one``; and the fused mode, K problems as one
  block-diagonal union (``serve.union``);
- ``serve.server``: ``ServeServer``, a request queue with a
  micro-batching window in front of the engine, and its HTTP front end
  behind ``python -m pydcop_tpu_torch serve``.
"""

from .batch import (
    BatchPlan,
    ServeUnsupported,
    SolveRequest,
    TenantResult,
    bucket_key,
    solve_batched,
    solve_one,
)
from .bucket import BucketDims, bucket_dims_of, pad_dev_to_bucket
from .server import ServeServer

__all__ = [
    "BatchPlan",
    "BucketDims",
    "ServeServer",
    "ServeUnsupported",
    "SolveRequest",
    "TenantResult",
    "bucket_dims_of",
    "bucket_key",
    "pad_dev_to_bucket",
    "solve_batched",
    "solve_one",
]
