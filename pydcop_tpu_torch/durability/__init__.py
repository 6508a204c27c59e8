"""Durable solves: checkpoint and resume of the cycle engine's carry,
and replayable dynamic workloads.

The port's counterpart of ``pydcop_tpu/durability/``: :mod:`.manager`
holds :class:`CheckpointManager` (cadence, rotation, atomic manifests
with problem fingerprints) and the :data:`durability` singleton
``run_cycles`` consults; :mod:`.replay` holds :class:`ScenarioSession`,
a ``DynamicMaxSum`` session driven by a scenario, checkpointed after
every event and resumable from any checkpoint.
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
from .replay import REPLAY_ACTIONS, ScenarioSession

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
    "REPLAY_ACTIONS",
    "ScenarioSession",
]
