"""Durable solves: checkpoint and resume of the cycle engine's carry.

:mod:`.manager` holds :class:`CheckpointManager` (cadence, rotation,
atomic manifests with problem fingerprints) and the :data:`durability`
singleton ``run_cycles`` consults, the port's counterpart of
``pydcop_tpu/durability/``.  The JAX package's scenario replay
(``durability/replay.py``) is not ported.
"""

from .manager import (
    DEFAULT_EVERY_CYCLES,
    DEFAULT_KEEP,
    MANIFEST_FORMAT,
    CheckpointManager,
    Durability,
    default_checkpoint_dir,
    durability,
    latest_checkpoint,
    list_manifests,
    problem_fingerprint,
    read_manifest,
    resolve_checkpoint_path,
)

__all__ = [
    "CheckpointManager",
    "Durability",
    "durability",
    "problem_fingerprint",
    "default_checkpoint_dir",
    "latest_checkpoint",
    "list_manifests",
    "read_manifest",
    "resolve_checkpoint_path",
    "MANIFEST_FORMAT",
    "DEFAULT_EVERY_CYCLES",
    "DEFAULT_KEEP",
]
