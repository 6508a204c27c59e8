"""``pydcop_tpu_torch checkpoints``: list, inspect and prune checkpoints.

Counterpart of the JAX package's ``checkpoints`` verb.  A checkpoint
directory holds ``ckpt-c<cycle>.npz`` payloads and their ``.json``
manifest sidecars; the listing reads only the sidecars, never the arrays,
and ``inspect`` falls back to the manifest embedded in the npz when a
sidecar was lost.  Host-only: it never touches the device, and it reads
the checkpoints of either package.
"""

from __future__ import annotations

import json
import logging
import sys

from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.checkpoints")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "checkpoints",
        help="list / inspect / prune checkpoint manifests",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "action", nargs="?", default="list",
        choices=["list", "inspect", "prune"],
        help="list manifests in a directory (default), inspect one "
        "checkpoint's full manifest, or prune old checkpoints",
    )
    parser.add_argument(
        "path", nargs="?", default=None,
        help="checkpoint directory (list/prune; default "
        "$PYDCOP_TPU_STATE_DIR/checkpoints) or checkpoint file (inspect)",
    )
    parser.add_argument(
        "--keep", type=int, default=None, metavar="N",
        help="prune: keep only the newest N checkpoints (default 3)",
    )


def _fmt_row(m) -> str:
    cost = m.get("best_cost")
    return (
        f"{m.get('cycle', '?'):>9}  {str(m.get('algo', '?')):<10} "
        f"{str(m.get('fingerprint', '?')):<17} "
        f"{'' if cost is None else f'{cost:.6g}':>12}  "
        f"{(m.get('bytes') or 0) / 1024.0:>9.1f}  "
        f"{m.get('kind', 'solve'):<7} {m['checkpoint_path']}"
    )


def run_cmd(args, timeout: float = None) -> int:
    from ..durability import (
        DEFAULT_KEEP,
        CheckpointManager,
        default_checkpoint_dir,
        list_manifests,
        read_manifest,
    )
    from ..utils.checkpoint import CheckpointError

    path = args.path or default_checkpoint_dir()
    if args.action == "inspect":
        if args.path is None:
            print(
                "checkpoints inspect: a checkpoint file (or directory) "
                "is required", file=sys.stderr,
            )
            return 2
        from ..durability import resolve_checkpoint_path

        try:
            ckpt = resolve_checkpoint_path(args.path)
            manifest = read_manifest(ckpt)
        except CheckpointError as e:
            print(f"checkpoints inspect: {e}", file=sys.stderr)
            return 1
        payload = {"checkpoint": ckpt, "manifest": manifest}
        write_output(args, payload)
        return 0

    if args.action == "prune":
        keep = DEFAULT_KEEP if args.keep is None else max(0, args.keep)
        mgr = CheckpointManager(path, keep=max(1, keep))
        removed = mgr.prune(keep)
        payload = {"directory": path, "kept": keep, "removed": removed}
        write_output(args, payload)
        return 0

    # list
    manifests = list_manifests(path)
    if getattr(args, "output", None):
        write_output(args, {"directory": path, "checkpoints": manifests})
        return 0
    if not manifests:
        print(f"no checkpoints under {path}")
        return 0
    print(
        f"{'cycle':>9}  {'algo':<10} {'fingerprint':<17} "
        f"{'best_cost':>12}  {'KiB':>9}  {'kind':<7} path"
    )
    for m in manifests:
        if "error" in m:
            print(f"        ?  {m['checkpoint_path']}: {m['error']}")
        else:
            print(_fmt_row(m))
    bad = sum(1 for m in manifests if "error" in m)
    print(
        f"{len(manifests)} checkpoint(s)"
        + (f", {bad} unreadable" if bad else "")
    )
    return 0
