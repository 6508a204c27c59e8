"""``capture``: perf-capture bundles and the per-op regression diff.

Counterpart of ``pydcop_tpu/commands/capture.py``; two modes behind one
verb:

- ``capture -o DIR [--configs N ...]`` runs the selected configs of
  ``tools/capture_configs.py`` with everything on (profiling, the graph
  dumps, the kernel blocks, the capture and read-back census) and writes
  a self-describing bundle: ``manifest.json`` (the card's name, its power
  limit, the torch and CUDA versions, the commit, the clock, the
  per-config index), ``records/config_<k>.json``, ``hlo/config_<k>/``
  (the CUDA-graph DOT dumps) and ``profile/config_<k>/`` (the
  ``torch.profiler`` trace, unless ``--no-profiler``).  ``--force``
  writes into an existing bundle and keeps its configs (a resumed
  capture).  It runs on the card unless the global ``--device cpu`` is
  given; without a card the CLI refuses.
- ``capture diff A B`` attributes the wall delta between two comparands
  (a bundle directory, a records file, or a quoted history glob: its
  median) per op and per phase, with census, recompile and roofline
  flags (``telemetry/perfdiff.py``).  Host only: it imports no torch,
  and the CLI does not look for a card.

The manifest's ``budget`` block is the JAX package's static dispatch
census (its ``analysis/budget.py``, the lint layer), which the port does
not have: the block is an ``{"error": ...}`` entry saying so, which the
diff skips.

Exit codes: capture 1 when a config errored or a ``KERNEL_CONFIGS``
record lost its attribution block, 2 on bad arguments; diff 1 when
significant deltas or flags exist, 2 when a comparand cannot be loaded.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from typing import Dict, List

from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.capture")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "capture",
        help="one-command perf-capture bundle, or `capture diff A B` "
        "per-op regression attribution",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "spec", nargs="*", default=[],
        help="`diff BASE FRESH` compares two comparands (bundle dir, "
        "records file, or a quoted history glob -> trajectory median); "
        "empty runs a capture",
    )
    parser.add_argument(
        "-o", "--out-dir", default=None, metavar="DIR",
        help="capture mode: bundle output directory (required)",
    )
    parser.add_argument(
        "--configs", nargs="+", default=None, metavar="N",
        help="capture mode: config numbers of tools/capture_configs.py "
        "(default: its DEFAULT_CONFIGS set)",
    )
    parser.add_argument(
        "--force", action="store_true",
        help="capture mode: write into a directory that already "
        "contains a bundle",
    )
    parser.add_argument(
        "--notes", default=None,
        help="capture mode: free-text note stored in the manifest",
    )
    parser.add_argument(
        "--no-profiler", action="store_true",
        help="capture mode: skip the torch.profiler session (graph dumps "
        "and census stay on; traces are large)",
    )
    parser.add_argument(
        "--json", default=None, metavar="FILE", dest="diff_json",
        help="diff mode: also write the machine-readable diff JSON",
    )
    parser.add_argument(
        "--all-metrics", action="store_true",
        help="diff mode: expand the per-op table for every metric, "
        "not just the significant ones",
    )
    # dest differs from the CLI's global --device (where to solve)
    parser.add_argument(
        "--device", default=None, dest="diff_device",
        help="diff mode: pin the device a trajectory-median comparand "
        "selects records for (default: majority device)",
    )


def is_diff_invocation(args) -> bool:
    """True for ``capture diff ...``: host only, so the CLI must not look
    for a card."""
    spec = getattr(args, "spec", None) or []
    return bool(spec) and spec[0] == "diff"


def run_cmd(args, timeout: float = None) -> int:
    if is_diff_invocation(args):
        return _diff_cmd(args)
    if args.spec:
        logger.error(
            "unknown capture subcommand %r (only `diff` takes "
            "positionals; a capture is `capture -o DIR`)", args.spec[0]
        )
        return 2
    return _capture_cmd(args)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def _budget_block() -> Dict:
    """The JAX package's static dispatch census has no counterpart here:
    an error entry, which ``capture diff`` skips."""
    return {
        "error": "no static dispatch census: the JAX package's lint layer "
        "(analysis/budget.py) is not ported"
    }


def _power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable: {type(exc).__name__}: {exc}"[:200]
    if out.returncode != 0:
        return f"unavailable: nvidia-smi exited {out.returncode}"
    return out.stdout.strip()


def _degraded_reasons() -> List[str]:
    """Label values of ``kernelprof.degraded`` counted by the config that
    just ran (each config resets the registry)."""
    from ..telemetry import metrics_registry

    metric = metrics_registry.get("kernelprof.degraded")
    if metric is None:
        return []
    reasons = []
    for entry in metric.snapshot().get("values", []):
        labels = dict(entry.get("labels") or {})
        if entry.get("value"):
            reasons.append(str(labels.get("reason", "unknown")))
    return reasons


def _capture_cmd(args) -> int:
    if not args.out_dir:
        logger.error("capture needs -o/--out-dir BUNDLE_DIR")
        return 2
    out = args.out_dir
    if os.path.exists(os.path.join(out, "manifest.json")) and not args.force:
        logger.error(
            "%s already holds a capture bundle (use --force to overwrite)",
            out,
        )
        return 2
    from ..tools import capture_configs

    wanted = [str(c) for c in (args.configs
                               or capture_configs.DEFAULT_CONFIGS)]
    unknown = [c for c in wanted if c not in capture_configs.CONFIGS]
    if unknown:
        logger.error(
            "unknown config(s) %s (have: %s)",
            ",".join(unknown), ",".join(sorted(capture_configs.CONFIGS)),
        )
        return 2

    import torch

    from ..compile.kernels import resolve_device
    from ..telemetry import perfdiff
    from ..telemetry.kernelprof import device_platform
    from ..telemetry.profiling import start_profiling, stop_profiling

    device = resolve_device(args.device)
    platform = device_platform(device)
    extra = {
        "device": platform,
        "device_count": (
            torch.cuda.device_count() if device.type == "cuda" else 1
        ),
        "backend": (
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu"
        ),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "state_dir": os.environ.get("PYDCOP_TPU_STATE_DIR"),
    }
    if device.type == "cuda":
        extra["power_limit"] = _power_limit()
    env = perfdiff.capture_environment(extra=extra)
    manifest = perfdiff.new_manifest(
        environment=env,
        created=time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        notes=args.notes,
    )
    manifest_path = os.path.join(out, "manifest.json")
    if os.path.exists(manifest_path):
        # --force resumes into an existing bundle: keep what was
        # captured, refresh the provenance
        try:
            with open(manifest_path) as fh:
                prior = json.load(fh)
            manifest["configs"] = prior.get("configs", {})
            manifest["warnings"] = prior.get("warnings", [])
        except (OSError, ValueError):
            pass
    manifest["budget"] = _budget_block()
    perfdiff.write_manifest(out, manifest)
    logger.warning(
        "capture -> %s (device=%s, configs=%s)", out, platform,
        ",".join(wanted),
    )

    failures = 0
    for key in wanted:
        hlo_dir = os.path.join(out, "hlo", f"config_{key}")
        profile_dir = (
            None if args.no_profiler
            else os.path.join(out, "profile", f"config_{key}")
        )
        os.makedirs(hlo_dir, exist_ok=True)
        start_profiling(profile_dir=profile_dir, hlo_dir=hlo_dir)
        try:
            record = capture_configs.run_config(key, device=device)
        finally:
            stop_profiling()
        warnings = []
        if record.get("error"):
            failures += 1
            warnings.append(f"config {key}: ERRORED: {record['error']}")
        state = perfdiff.attribution_state(record)
        degraded = _degraded_reasons()
        if key in capture_configs.KERNEL_CONFIGS and state != "ok":
            failures += 1
            warnings.append(
                f"config {key} ({record.get('metric')}): per-op "
                f"attribution MISSING ({state}"
                + (f"; degraded: {','.join(degraded)}" if degraded else "")
                + ") — this bundle cannot explain a regression per-op"
            )
        perfdiff.append_record(out, record, manifest, warnings=warnings)
        for w in warnings:
            logger.error("capture: %s", w)
        logger.warning(
            "capture: config %s %s = %s %s (attribution: %s)",
            key, record.get("metric"), record.get("value"),
            record.get("unit", ""), state,
        )
    payload = {
        "bundle": out,
        "device": platform,
        "configs": manifest["configs"],
        "warnings": manifest["warnings"],
        "budget_problems": (manifest["budget"] or {}).get("problems"),
    }
    write_output(args, payload)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------


def _diff_cmd(args) -> int:
    from ..telemetry import perfdiff

    spec = args.spec[1:]
    if len(spec) != 2:
        logger.error("usage: pydcop_tpu_torch capture diff BASE FRESH")
        return 2
    try:
        base = perfdiff.load_side(spec[0], device=args.diff_device)
        fresh = perfdiff.load_side(spec[1], device=args.diff_device)
    except (OSError, ValueError) as exc:
        logger.error("capture diff: %s", exc)
        return 2
    diff = perfdiff.diff_sides(base, fresh)
    print(perfdiff.format_diff(diff, all_metrics=args.all_metrics))
    if args.diff_json:
        with open(args.diff_json, "w") as fh:
            json.dump(diff, fh, indent=2, sort_keys=True)
            fh.write("\n")
        logger.warning("diff json -> %s", args.diff_json)
    return 1 if (diff["significant"] or diff["flags"]) else 0
