"""The distribution layer: computations placed on agents.

Counterpart of ``pydcop_tpu/distribution/``, in part: its objects (the
YAML loader's hints, ``Distribution``) and the ``tpu_part`` method, which
the HA router uses to lay its affinity buckets on workers.  The other
distribution methods and the ``distribute`` verb are not ported.
"""
