"""Many-tenant batched solving on the card.

Counterpart of ``pydcop_tpu/serve/``:

- ``serve.bucket``: shape buckets, every padded ``DeviceDCOP`` dimension
  rounded up to a power of two, so problems of one size class share a
  batch and its captured graphs;
- ``serve.batch``: the batch engine, K bucket-padded problems solved as
  one (``algorithms.base.run_batch``: the engine mapped over an instance
  axis, each kernel one launch for the batch), each tenant's result the
  bits of its solo ``solve_one``; and the fused mode, K problems as one
  block-diagonal union (``serve.union``);
- ``serve.server``: ``ServeServer``, a request queue with a
  micro-batching window in front of the engine, its routes on the live
  metrics surface (``/metrics``, ``/healthz``, ``/slo``, ...), trace ids
  and request phases, behind ``python -m pydcop_tpu_torch serve``;
- ``serve.router``: ``Router``, the HA fleet behind ``python -m
  pydcop_tpu_torch router``: affinity placement of tenants on serve
  workers, SLO admission and failover.  Host-only: it imports no torch,
  so this package resolves its names lazily.
"""

# Public names are resolved lazily (PEP 562): importing ``serve.router``
# (the host-only router verb) must not import the batch engine's torch.
_LAZY = {
    "BatchPlan": "batch",
    "ServeUnsupported": "batch",
    "SolveRequest": "batch",
    "TenantResult": "batch",
    "bucket_key": "batch",
    "solve_batched": "batch",
    "solve_one": "batch",
    "BucketDims": "bucket",
    "bucket_dims_of": "bucket",
    "pad_dev_to_bucket": "bucket",
    "ServeServer": "server",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
