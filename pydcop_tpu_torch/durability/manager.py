"""Checkpoint/resume manager behind durable solves.

The port's counterpart of ``pydcop_tpu/durability/manager.py``, the same
policy and the same files: a :class:`CheckpointManager` snapshots the
cycle engine's carry (algorithm state, anytime best, stability counter,
the pulse flip counters) at chunk boundaries, writes it atomically
through :mod:`pydcop_tpu_torch.utils.checkpoint` (the JAX package's npz
format, its leaves in JAX's order) and rotates old snapshots away.

Every checkpoint carries a MANIFEST, embedded in the ``.npz`` and twinned
into a ``.json`` sidecar so listing never loads arrays: the problem
fingerprint, algorithm, seed, noise level, cycle index, best so far and
the carry layout.  A resume refuses a mismatched problem, algorithm or
seed loudly, and the ``checkpoints`` verb inspects a directory without
touching the device.  ``problem_fingerprint`` hashes the compiled arrays
as the JAX package does, so a checkpoint of either package resumes in
the other.

Per-cycle keys are functions of the absolute cycle index, so a resumed
solve continues on the bit-identical trajectory of the uninterrupted
run: the manifest's seed and cycle are all the entropy there is.

The module-level :data:`durability` singleton is how the CLI reaches the
engine without threading a manager through every algorithm signature;
``run_cycles`` consults it once per solve.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import tracer
from ..utils.checkpoint import (
    CheckpointError,
    atomic_write_json,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "Durability",
    "durability",
    "problem_fingerprint",
    "default_checkpoint_dir",
    "list_manifests",
    "latest_checkpoint",
    "resolve_checkpoint_path",
    "MANIFEST_FORMAT",
    "DEFAULT_EVERY_CYCLES",
    "DEFAULT_KEEP",
]

logger = logging.getLogger("pydcop_tpu_torch.durability")

#: manifest schema tag — bump on incompatible layout changes
MANIFEST_FORMAT = "graftdur-v1"

#: cadence default when --checkpoint is given without --checkpoint-every
DEFAULT_EVERY_CYCLES = 64

#: rotation default: keep the last N checkpoints
DEFAULT_KEEP = 3

#: snapshot filename stem; the 9-digit zero-padded cycle keeps
#: lexicographic order == cycle order for glob-based listing
CKPT_STEM = "ckpt-c"

_m_checkpoints = metrics_registry.counter(
    "durability.checkpoints", "solver checkpoints written"
)
_m_bytes = metrics_registry.counter(
    "durability.checkpoint_bytes", "checkpoint bytes written (npz)"
)
_m_resumes = metrics_registry.counter(
    "durability.resumes", "solves resumed from a checkpoint"
)
_m_pruned = metrics_registry.counter(
    "durability.pruned", "checkpoints removed by rotation/prune"
)
_m_save_seconds = metrics_registry.histogram(
    "durability.save_seconds", "checkpoint write latency (host)"
)
_m_last_cycle = metrics_registry.gauge(
    "durability.last_cycle", "cycle index of the newest checkpoint"
)


def _state_dir() -> str:
    """The repo's scratch-state convention (bench progress files, lint
    cache): ``$PYDCOP_TPU_STATE_DIR``, default ``.bench_state/``."""
    return os.environ.get("PYDCOP_TPU_STATE_DIR") or ".bench_state"


def default_checkpoint_dir() -> str:
    """Where ``--checkpoint`` without a directory lands (gitignored with
    the rest of the state dir; docs/durability.md)."""
    return os.path.join(_state_dir(), "checkpoints")


def problem_fingerprint(compiled) -> str:
    """Stable 16-hex-digit fingerprint of a compiled problem: variable
    names, domains, edge layout and every cost table — what a checkpoint
    must match before its arrays are allowed anywhere near a solver.

    blake2b over the canonical arrays (NOT python ``hash``, which is
    salted per process and would break cross-run resume).  Cached on the
    compiled object: the tables of a 100k-variable problem hash in ~ms,
    but every chunk boundary asking again would still be waste."""
    fp = getattr(compiled, "_durability_fingerprint", None)
    if fp is not None:
        return fp
    h = hashlib.blake2b(digest_size=8)
    h.update(
        f"{compiled.objective}|{compiled.n_vars}|{compiled.max_domain}|"
        f"{compiled.n_edges}|{len(compiled.buckets)}".encode("utf-8")
    )
    h.update("\x00".join(compiled.var_names).encode("utf-8"))
    h.update(np.ascontiguousarray(compiled.domain_size).tobytes())
    h.update(np.ascontiguousarray(compiled.edge_var).tobytes())
    h.update(np.ascontiguousarray(compiled.unary).tobytes())
    for b in compiled.buckets:
        h.update(np.ascontiguousarray(b.tables).tobytes())
        h.update(np.ascontiguousarray(b.var_slots).tobytes())
    fp = h.hexdigest()
    try:
        object.__setattr__(compiled, "_durability_fingerprint", fp)
    except (AttributeError, TypeError):
        pass  # uncacheable host object: recompute per call
    return fp


def _manifest_path(npz_path: str) -> str:
    return npz_path[: -len(".npz")] + ".json" if npz_path.endswith(
        ".npz"
    ) else npz_path + ".json"


def _to_host_leaf(x):
    """A leaf on the host: a tensor is copied to the CPU (keeping its
    dtype, bf16 included), anything else becomes a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def _tree_to_host(tree):
    """``tree`` (tensors, arrays, tuples, lists and dicts) with every leaf
    on the host."""
    if isinstance(tree, dict):
        return {k: _tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_to_host(x) for x in tree)
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_to_host(x) for x in tree))
    if tree is None:
        return None
    return _to_host_leaf(tree)


def list_manifests(directory: str) -> List[Dict[str, Any]]:
    """All checkpoint manifests under ``directory`` (recursive one level:
    the dir itself plus run subdirectories), sorted by (path).  Reads only
    the ``.json`` sidecars — never the array payloads."""
    out: List[Dict[str, Any]] = []
    patterns = [
        os.path.join(directory, f"{CKPT_STEM}*.json"),
        os.path.join(directory, "*", f"{CKPT_STEM}*.json"),
    ]
    for pat in patterns:
        for mp in sorted(glob.glob(pat)):
            try:
                with open(mp, "r", encoding="utf-8") as f:
                    man = json.load(f)
            except (OSError, ValueError) as e:
                man = {"error": f"unreadable manifest: {e}"}
            npz = mp[: -len(".json")] + ".npz"
            man["manifest_path"] = mp
            man["checkpoint_path"] = npz
            try:
                man["bytes"] = os.path.getsize(npz)
            except OSError:
                man["bytes"] = None
                man.setdefault("error", "payload .npz missing")
            out.append(man)
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest (highest-cycle, then newest-written) checkpoint ``.npz``
    under ``directory``, or None."""
    mans = [m for m in list_manifests(directory) if "error" not in m]
    if not mans:
        return None
    mans.sort(
        key=lambda m: (m.get("cycle", -1), m.get("wrote_unix_s", 0.0))
    )
    return mans[-1]["checkpoint_path"]


def resolve_checkpoint_path(path: str) -> str:
    """``--resume PATH`` accepts a checkpoint file OR a directory (the
    newest checkpoint in it).  Raises CheckpointError when nothing is
    there — a resume must never silently start fresh."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise CheckpointError(
                f"--resume {path}: no checkpoint manifests in directory"
            )
        return latest
    if not os.path.exists(path):
        raise CheckpointError(f"--resume {path}: no such checkpoint")
    return path


def read_manifest(path: str) -> Dict[str, Any]:
    """The manifest of one checkpoint ``.npz`` — sidecar first (cheap),
    embedded npz metadata as the fallback when the sidecar was lost."""
    mp = _manifest_path(path)
    if os.path.exists(mp):
        try:
            with open(mp, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            pass
    _, meta = load_checkpoint(path)
    if not isinstance(meta, dict) or not meta:
        raise CheckpointError(
            f"{path}: no manifest (sidecar missing and no embedded "
            f"metadata) — not a graftdur checkpoint?"
        )
    return meta


class CheckpointManager:
    """Cadence + rotation + manifest policy over one checkpoint directory.

    ``every_cycles`` / ``every_seconds`` may combine: a snapshot is due at
    every k-th cycle boundary OR once ``every_seconds`` elapsed since the
    last write, whichever comes first.  With neither given the cycle
    cadence defaults to :data:`DEFAULT_EVERY_CYCLES`.

    One manager serves one logical run; ``bind`` pins the problem
    fingerprint + solve identity the manifests carry.  Thread-safe for the
    save path (the serve drain and a solve loop may share a process)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        every_cycles: Optional[int] = None,
        every_seconds: Optional[float] = None,
        keep: int = DEFAULT_KEEP,
    ) -> None:
        if not directory:
            directory = default_checkpoint_dir()
        self.directory = directory
        if every_cycles is None and every_seconds is None:
            every_cycles = DEFAULT_EVERY_CYCLES
        if every_cycles is not None and every_cycles <= 0:
            raise ValueError(
                f"--checkpoint-every must be positive, got {every_cycles}"
            )
        self.every_cycles = every_cycles
        self.every_seconds = every_seconds
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._last_save_t = time.monotonic()
        self._context: Dict[str, Any] = {}
        self.saved_paths: List[str] = []
        self.bound = False

    # -- solve binding -------------------------------------------------

    def bind(
        self,
        compiled,
        algo: str,
        seed: int,
        noise: float,
        n_cycles: int,
        extra: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Pin the identity every subsequent manifest carries.  Called by
        ``run_cycles`` at solve start (and by the scenario replay per
        session).

        The FIRST problem to bind claims the manager: a later solve of a
        DIFFERENT problem in the same process (the thread runtime's
        repair DCOPs ride the same ``run_cycles``) returns False and is
        not checkpointed — otherwise its snapshots would overwrite the
        main solve's trail under the same cycle filenames, and a resume
        would find repair-problem checkpoints where the run's belong.
        Re-binding the SAME problem (bench repetitions, retries) is
        fine.  The scenario replay mutates its problem between events, so
        it passes ``rebind=True`` via :meth:`rebind`."""
        fp = problem_fingerprint(compiled)
        context = {
            "fingerprint": fp,
            "algo": algo,
            "seed": int(seed),
            "noise": float(noise),
            "n_cycles": int(n_cycles),
            "n_vars": int(compiled.n_vars),
        }
        if extra:
            context.update(extra)
        with self._lock:
            if self.bound and self._context.get("fingerprint") != fp:
                logger.info(
                    "checkpoint manager for %s (problem %s) ignoring a "
                    "solve of different problem %s (%s) — auxiliary "
                    "solves are not checkpointed",
                    self.directory, self._context.get("fingerprint"),
                    fp, algo,
                )
                return False
            self._context = context
            self._last_save_t = time.monotonic()
            self.bound = True
        return True

    def rebind(
        self,
        compiled,
        algo: str,
        seed: int,
        noise: float,
        n_cycles: int,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Like :meth:`bind` but always adopts the new problem identity —
        for owners whose ONE logical workload legitimately changes
        fingerprint over time (the scenario replay's factor
        swaps)."""
        with self._lock:
            self.bound = False
        self.bind(compiled, algo, seed, noise, n_cycles, extra=extra)

    # -- cadence -------------------------------------------------------

    def cycles_to_boundary(self, done: int) -> Optional[int]:
        """Cycles until the next every-k boundary (None without a cycle
        cadence) — how ``run_cycles`` sizes its chunks so snapshots ride
        the host syncs it was already paying for."""
        k = self.every_cycles
        if k is None:
            return None
        return k - (done % k) if done % k else k

    def due(self, done: int) -> bool:
        """Is a snapshot due at this chunk boundary?"""
        if self.every_cycles is not None and done > 0 and (
            done % self.every_cycles == 0
        ):
            return True
        if self.every_seconds is not None:
            with self._lock:
                last = self._last_save_t
            if time.monotonic() - last >= self.every_seconds:
                return True
        return False

    # -- writing -------------------------------------------------------

    def save_carry(
        self,
        carry: Any,
        cycle: int,
        best_cost: Optional[float] = None,
        cycles_to_best: Optional[int] = None,
        kind: str = "solve",
        extra: Optional[Dict[str, Any]] = None,
        manifest_fields: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write one snapshot + manifest atomically, rotate, account.

        ``carry`` is any tree of (device or host) tensors and arrays
        (dicts flatten in sorted key order, as JAX's trees do); the caller
        owns its layout and records what matters for reload in the
        manifest (``has_pulse`` etc. via ``extra``; ``manifest_fields``
        merge at the TOP level — the scenario replay uses this to speak
        ``DynamicMaxSum.restore``'s metadata dialect)."""
        t0 = time.perf_counter()
        host_carry = _tree_to_host(carry)
        manifest: Dict[str, Any] = {
            "format": MANIFEST_FORMAT,
            "kind": kind,
            "cycle": int(cycle),
            "wrote_unix_s": time.time(),
        }
        with self._lock:
            manifest.update(self._context)
        if best_cost is not None:
            manifest["best_cost"] = float(best_cost)
        if cycles_to_best is not None:
            manifest["cycles_to_best"] = int(cycles_to_best)
        if manifest_fields:
            manifest.update(manifest_fields)
        if extra:
            manifest["extra"] = dict(extra)
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(
                self.directory, f"{CKPT_STEM}{int(cycle):09d}.npz"
            )
            save_checkpoint(path, host_carry, metadata=manifest)
            atomic_write_json(
                _manifest_path(path), manifest, indent=2, sort_keys=True,
            )
            if path in self.saved_paths:
                self.saved_paths.remove(path)  # same-cycle overwrite
            self.saved_paths.append(path)
            self._rotate_locked()
            self._last_save_t = time.monotonic()
        dt = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        if metrics_registry.enabled:
            _m_checkpoints.inc()
            _m_bytes.inc(nbytes)
            _m_save_seconds.observe(dt)
            _m_last_cycle.set(int(cycle))
        if tracer.enabled:
            tracer.complete(
                "durability.checkpoint", t0, dt, cat="durability",
                cycle=int(cycle), bytes=nbytes, kind=kind,
            )
        logger.info(
            "checkpoint: cycle %d -> %s (%.1f KiB, %.1f ms)",
            cycle, path, nbytes / 1024.0, dt * 1e3,
        )
        return path

    def _rotate_locked(self) -> None:
        """Keep-last-N over the snapshots THIS manager wrote (a directory
        shared with older runs never loses their checkpoints to a new
        run's rotation).  Caller holds the lock."""
        while len(self.saved_paths) > self.keep:  # graftlint: disable=lock-unguarded-read (caller save_carry holds self._lock)
            victim = self.saved_paths.pop(0)  # graftlint: disable=lock-unguarded-write (caller save_carry holds self._lock)
            for p in (victim, _manifest_path(victim)):
                try:
                    os.remove(p)
                except OSError:
                    pass
            if metrics_registry.enabled:
                _m_pruned.inc()

    # -- reading -------------------------------------------------------

    @staticmethod
    def load_carry(
        path: str,
        template_fn: Callable[[Dict[str, Any]], Any],
        compiled=None,
        algo: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        """Load one snapshot for a resume, refusing mismatches LOUDLY.

        ``template_fn(manifest)`` builds the like-structured pytree (it
        sees the manifest first, so optional sections — the graftpulse
        carry — shape the template).  ``compiled``/``algo``/``seed``,
        when given, are validated against the manifest: a checkpoint from
        a different problem, algorithm or seed raises
        :class:`CheckpointError` naming both sides instead of silently
        corrupting the solve."""
        path = resolve_checkpoint_path(path)
        manifest = read_manifest(path)
        if compiled is not None and "fingerprint" in manifest:
            want = problem_fingerprint(compiled)
            got = manifest["fingerprint"]
            if want != got:
                raise CheckpointError(
                    f"checkpoint {path} is from a DIFFERENT problem: "
                    f"manifest fingerprint {got} (algo "
                    f"{manifest.get('algo')!r}, {manifest.get('n_vars')} "
                    f"vars) vs this problem's {want} — refusing to resume"
                )
        if algo is not None and manifest.get("algo") not in (None, algo):
            raise CheckpointError(
                f"checkpoint {path} was written by algorithm "
                f"{manifest.get('algo')!r}, not {algo!r} (fingerprint "
                f"{manifest.get('fingerprint')}) — refusing to resume"
            )
        if seed is not None and manifest.get("seed") not in (
            None, int(seed)
        ):
            raise CheckpointError(
                f"checkpoint {path} was written with seed "
                f"{manifest.get('seed')}, not {seed}: the resumed "
                f"trajectory would diverge from the recorded one — "
                f"refusing (pass the checkpoint's seed for a "
                f"bit-identical continuation)"
            )
        template = template_fn(manifest)
        carry, meta = load_checkpoint(path, like=template)
        if metrics_registry.enabled:
            _m_resumes.inc()
        logger.info(
            "resuming %s solve at cycle %s from %s (fingerprint %s)",
            manifest.get("algo"), manifest.get("cycle"), path,
            manifest.get("fingerprint"),
        )
        return carry, (manifest or meta)

    # -- maintenance ---------------------------------------------------

    def prune(self, keep: Optional[int] = None) -> int:
        """Drop all but the newest ``keep`` checkpoints in the directory
        (by manifest cycle; unreadable manifests are never touched).
        Returns the number removed."""
        keep = self.keep if keep is None else max(0, int(keep))
        mans = [
            m for m in list_manifests(self.directory) if "error" not in m
        ]
        mans.sort(
            key=lambda m: (m.get("cycle", -1), m.get("wrote_unix_s", 0.0))
        )
        victims = mans[: max(0, len(mans) - keep)]
        for m in victims:
            for p in (m["checkpoint_path"], m["manifest_path"]):
                try:
                    os.remove(p)
                except OSError:
                    pass
            if metrics_registry.enabled:
                _m_pruned.inc()
        return len(victims)


class Durability:
    """Process-wide durability switchboard (CLI -> solve loop), same
    singleton pattern as ``telemetry.pulse``: ``run_cycles`` consults it
    once per solve, so no algorithm signature carries a manager.

    ``arm_resume`` is consumed by the FIRST solve that starts afterwards
    (the CLI runs exactly one); ``scenario cursor`` notes ride every
    subsequent manifest so scenario-driven runs are replayable from any
    checkpoint."""

    def __init__(self) -> None:
        self.manager: Optional[CheckpointManager] = None
        self._resume_path: Optional[str] = None
        self._lock = threading.Lock()
        self._extra: Dict[str, Any] = {}
        self.last_resume: Optional[Dict[str, Any]] = None

    # -- configuration (CLI / tests) -----------------------------------

    def configure(
        self,
        manager: Optional[CheckpointManager] = None,
        resume: Optional[str] = None,
    ) -> None:
        with self._lock:
            self.manager = manager
            self._resume_path = resume
            self.last_resume = None
            self._extra = {}

    def reset(self) -> None:
        self.configure(None, None)

    @property
    def active(self) -> bool:
        """Does the next solve checkpoint or resume?  One cheap check on
        the run_cycles fast path — durability off compiles and runs the
        exact pre-graftdur program, so this read is deliberately
        LOCK-FREE (same plain-attribute-flag pattern as
        ``tracer.enabled``/``pulse.enabled``; configure() publishes both
        fields atomically enough for a boolean gate — a racing reader
        takes the manager-claim path and re-reads under no worse
        assumptions)."""
        return self.manager is not None or self._resume_path is not None  # graftlint: disable=lock-unguarded-read (lock-free enabled-flag pattern, see docstring)

    # -- solve-loop side -----------------------------------------------

    def take_resume(self) -> Optional[str]:
        """Claim the armed resume path (once): the first solve to start
        owns it — a later solve in the same process starts fresh instead
        of silently re-resuming."""
        with self._lock:
            path, self._resume_path = self._resume_path, None
            return path

    def note_resumed(self, manifest: Dict[str, Any], path: str) -> None:
        with self._lock:
            self.last_resume = {
                "path": path,
                "cycle": manifest.get("cycle"),
                "algo": manifest.get("algo"),
                "fingerprint": manifest.get("fingerprint"),
            }

    # -- scenario / session annotations --------------------------------

    def note_extra(self, **fields: Any) -> None:
        """Attach fields to every subsequent manifest (scenario cursor,
        dynamic-session progress...)."""
        with self._lock:
            self._extra.update(fields)

    def runtime_extra(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._extra)

    # -- surfaces ------------------------------------------------------

    def status_block(self) -> Optional[Dict[str, Any]]:
        """The ``durability`` block of /status (None when off) — where
        the checkpoints land, how many, the newest cycle, and what this
        run resumed from."""
        with self._lock:
            mgr = self.manager
            last_resume = (
                dict(self.last_resume)
                if self.last_resume is not None else None
            )
            extra = dict(self._extra)
        if mgr is None and last_resume is None:
            return None
        out: Dict[str, Any] = {}
        if mgr is not None:
            saved = list(mgr.saved_paths)
            out.update(
                {
                    "directory": mgr.directory,
                    "every_cycles": mgr.every_cycles,
                    "every_seconds": mgr.every_seconds,
                    "keep": mgr.keep,
                    "checkpoints": len(saved),
                    "last_path": saved[-1] if saved else None,
                }
            )
        if extra:
            out["extra"] = extra
        if last_resume is not None:
            out["resumed_from"] = last_resume
        return out


#: the process singleton run_cycles and the CLI share
durability = Durability()
