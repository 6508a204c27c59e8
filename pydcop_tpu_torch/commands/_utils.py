"""Shared helpers for CLI commands.

Counterpart of ``pydcop_tpu/commands/_utils.py`` (the part the ``solve``,
``serve`` and ``orchestrator`` verbs use): parse ``--algo_params
name:value`` pairs into a validated ``AlgorithmDef``, write the JSON
result, the CSV, durability, pulse, trace and metrics flags with their
start and finish around a solve (``--profile-out``/``--dump-hlo`` among
them; with the registry on, the event-bus bridge is attached, as the JAX
package's ``start_telemetry`` does), the ``--fault-schedule`` flag with
its controller and its report, and the memory guard's flags.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, List, Optional

from ..algorithms import AlgorithmDef

__all__ = [
    "add_chaos_arguments", "add_csvio_arguments", "add_durability_arguments",
    "add_memguard_arguments", "add_runtime_arguments",
    "add_telemetry_arguments", "build_algo_def", "build_chaos_controller",
    "chaos_report", "configure_memguard", "finish_durability", "finish_telemetry",
    "parse_params", "start_durability", "start_telemetry", "write_output",
]


def parse_params(param_strs: Optional[List[str]]) -> Dict[str, str]:
    """``name:value`` pairs -> dict."""
    out: Dict[str, str] = {}
    for p in param_strs or []:
        if ":" not in p:
            raise ValueError(
                f"invalid algo parameter {p!r}: expected name:value"
            )
        name, value = p.split(":", 1)
        out[name.strip()] = value.strip()
    return out


def build_algo_def(
    algo_name: str,
    param_strs: Optional[List[str]] = None,
    mode: str = "min",
) -> AlgorithmDef:
    params = parse_params(param_strs)
    return AlgorithmDef.build_with_default_param(
        algo_name, params, mode=mode
    )


def write_output(args, payload: Dict[str, Any]) -> None:
    """JSON result to --output file or stdout."""
    text = json.dumps(payload, indent=2, default=str, sort_keys=True)
    output = getattr(args, "output", None)
    if output:
        with open(output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)


def add_csvio_arguments(parser) -> None:
    parser.add_argument(
        "--run_metrics",
        default=None,
        help="CSV file for run-time metrics",
    )
    parser.add_argument(
        "--end_metrics",
        default=None,
        help="CSV file to append end-of-run metrics to",
    )


def add_runtime_arguments(parser) -> None:
    """-i/--infinity, --delay and --uiport: the options of ``solve`` and
    ``run`` that shape the agent runtime and the cost reporting."""
    from ..constants import INFINITY

    parser.add_argument(
        "-i", "--infinity", type=float, default=INFINITY,
        help="value standing in for symbolic infinity when reporting "
        f"hard-constraint costs (default {INFINITY})",
    )
    parser.add_argument(
        "--delay", type=float, default=None,
        help="artificial delay (seconds) between message deliveries, to "
        "observe a run through the UI; thread mode only",
    )
    parser.add_argument(
        "--uiport", type=int, default=None,
        help="base port of the per-agent websocket UI servers; thread "
        "mode only (agents get uiport, uiport+1, ...)",
    )


def add_telemetry_arguments(parser) -> None:
    """--pulse-out, --trace-out, --metrics-out, --profile-out,
    --dump-hlo and --metrics-port: the telemetry flags of ``solve`` and
    ``run``, turned on by ``start_telemetry``."""
    parser.add_argument(
        "--pulse-out", default=None, metavar="FILE",
        help="compute per-cycle health vectors in the cycle loop and "
        "stream them to FILE as JSONL; arms the flight recorder "
        "(postmortem.json on a timeout)",
    )
    parser.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="record spans (the engine's readback windows and read-backs) "
        "and write a Chrome trace to FILE (JSONL for a .jsonl path)",
    )
    parser.add_argument(
        "--metrics-out", default=None, metavar="FILE",
        help="enable the metrics registry and write its JSON snapshot to "
        "FILE at exit",
    )
    parser.add_argument(
        "--profile-out", default=None, metavar="DIR",
        help="record a torch.profiler timeline of the solve into DIR (a "
        "Chrome trace: Perfetto, TensorBoard), CUDA kernels and CPU ops, "
        "with ranges per algorithm phase, chunk and read-back; implies "
        "the metrics registry; a profiler that cannot start is counted "
        "(device.profiler_unavailable) and the solve runs the same",
    )
    parser.add_argument(
        "--dump-hlo", default=None, metavar="DIR",
        help="save every fresh CUDA-graph capture as a DOT file in DIR "
        "(<entry point>.<n>.graph.dot: what the card replays); implies "
        "the metrics registry",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="enable the metrics registry and pulse and serve the live "
        "surface from the orchestrator: /metrics (Prometheus text), "
        "/metrics.json and /status, for the watch verb (0 = a free port; "
        "thread/process modes; direct mode serves none)",
    )


def add_memguard_arguments(parser) -> None:
    """The memory guard's flags, shared by ``solve`` and ``serve``."""
    parser.add_argument(
        "--mem-guard", action="store_true",
        help="refuse a solve or admission whose predicted device bytes "
        "exceed the device's memory minus the reserve: a named refusal "
        "(predicted against the budget, the dominant component) before "
        "anything is uploaded, instead of a torch.OutOfMemoryError "
        "partway through the solve",
    )
    parser.add_argument(
        "--mem-reserve-pct", type=float, default=None, metavar="PCT",
        help="percent of the device's memory the guard keeps free "
        "(default 10); implies --mem-guard",
    )
    parser.add_argument(
        "--mem-limit-bytes", type=int, default=None, metavar="BYTES",
        help="the byte limit the guard budgets against, in place of the "
        "card's total memory (a CPU has none); implies --mem-guard",
    )


def configure_memguard(args) -> bool:
    """Arm the memory guard as the flags say (any of the three arms
    it); True when armed."""
    if not (
        getattr(args, "mem_guard", False)
        or getattr(args, "mem_reserve_pct", None) is not None
        or getattr(args, "mem_limit_bytes", None) is not None
    ):
        return False
    from ..telemetry.memplane import memguard

    memguard.configure(
        enabled=True,
        reserve_pct=getattr(args, "mem_reserve_pct", None),
        limit_bytes=getattr(args, "mem_limit_bytes", None),
    )
    return True


def add_durability_arguments(parser) -> None:
    """--checkpoint/--resume: the durability flags of ``solve``."""
    parser.add_argument(
        "--checkpoint", nargs="?", const="", default=None, metavar="DIR",
        help="periodically checkpoint the solver carry to DIR (atomic npz "
        "+ manifest; default DIR = $PYDCOP_TPU_STATE_DIR/checkpoints).  "
        "Snapshots ride the cycle loop's chunk boundaries; a killed run "
        "resumes with --resume to the bit-identical trajectory of the "
        "uninterrupted run",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="K",
        help="checkpoint cadence in cycles (default 64); combines with "
        "--checkpoint-every-seconds (whichever is due first)",
    )
    parser.add_argument(
        "--checkpoint-every-seconds", type=float, default=None,
        metavar="T",
        help="checkpoint cadence in wall seconds (checked at chunk "
        "boundaries)",
    )
    parser.add_argument(
        "--checkpoint-keep", type=int, default=None, metavar="N",
        help="rotation: keep the last N checkpoints (default 3)",
    )
    parser.add_argument(
        "--resume", default=None, metavar="PATH",
        help="resume a killed solve from a checkpoint file (or the newest "
        "one in a directory); the manifest must match this problem, "
        "algorithm and seed or the resume refuses loudly",
    )


def start_durability(args):
    """Configure the durability singleton from the CLI flags; returns the
    manager (or None) for ``finish_durability``.  ``--resume`` is resolved
    before the solve, so a missing path fails fast."""
    ckpt_dir = getattr(args, "checkpoint", None)
    resume = getattr(args, "resume", None)
    if ckpt_dir is None and resume is None:
        for flag in (
            "checkpoint_every", "checkpoint_every_seconds",
            "checkpoint_keep",
        ):
            if getattr(args, flag, None) is not None:
                logging.getLogger("pydcop_tpu_torch.durability").warning(
                    "--%s has no effect without --checkpoint",
                    flag.replace("_", "-"),
                )
        return None
    from ..durability import (
        DEFAULT_KEEP,
        CheckpointManager,
        durability,
        resolve_checkpoint_path,
    )

    manager = None
    if ckpt_dir is not None:
        keep = getattr(args, "checkpoint_keep", None)
        manager = CheckpointManager(
            ckpt_dir or None,
            every_cycles=getattr(args, "checkpoint_every", None),
            every_seconds=getattr(args, "checkpoint_every_seconds", None),
            keep=DEFAULT_KEEP if keep is None else keep,
        )
    if resume is not None:
        resume = resolve_checkpoint_path(resume)
    durability.configure(manager=manager, resume=resume)
    return manager


def finish_durability(args, manager) -> None:
    """Report what durability did and switch the singleton back off (in a
    ``finally``, beside ``finish_telemetry``)."""
    if (
        getattr(args, "checkpoint", None) is None
        and getattr(args, "resume", None) is None
    ):
        return
    from ..durability import durability

    logger = logging.getLogger("pydcop_tpu_torch.durability")
    if manager is not None:
        if manager.saved_paths:
            logger.info(
                "%d checkpoint(s) in %s (newest: %s)",
                len(manager.saved_paths), manager.directory,
                manager.saved_paths[-1],
            )
        elif not manager.bound:
            logger.warning(
                "--checkpoint: no checkpoints written: the algorithm never "
                "entered the cycle loop (one-shot solvers like dpop have "
                "no checkpointable carry)"
            )
        else:
            logger.warning(
                "--checkpoint: solve finished before the first cadence "
                "boundary (every %s cycles / %s s): nothing written",
                manager.every_cycles, manager.every_seconds,
            )
    durability.reset()


def add_chaos_arguments(parser) -> None:
    """--fault-schedule: the chaos flag of ``solve`` and ``run``."""
    parser.add_argument(
        "--fault-schedule", default=None, metavar="FILE",
        help="YAML fault schedule (seeded kills / message faults / device "
        "faults) injected into the run: process kills (kill_process) in "
        "direct and thread mode and in run; agent kills and device faults "
        "in thread mode and in run (ignored in direct mode); message rules "
        "are refused (not ported yet)",
    )


def build_chaos_controller(args):
    """A ChaosController from --fault-schedule, or None when unset."""
    path = getattr(args, "fault_schedule", None)
    if not path:
        return None
    from ..chaos import ChaosController, load_fault_schedule

    return ChaosController(load_fault_schedule(path))


def chaos_report(controller, orchestrator) -> Dict[str, Any]:
    """The ``chaos`` block of a fault-injected runtime run's result: the
    deterministic event log, per-action counts, and the dead-letter total
    across the orchestrator and every local agent."""
    return {
        "seed": controller.seed,
        "events": controller.event_log(),
        "counts": controller.action_counts(),
        "dead_letters": orchestrator.dead_letter_total(),
    }


def start_telemetry(args):
    """Turn on what the CLI flags ask for: ``--trace-out`` the span
    tracer, ``--metrics-out`` the metrics registry (both reset first),
    ``--pulse-out`` the per-cycle health vectors computed in the cycle
    loop, streamed as JSONL, with the flight recorder armed.
    ``--metrics-port`` turns on the registry and pulse, as the JAX
    package's flag does for the orchestrator's live surface.
    ``--profile-out DIR`` opens a ``torch.profiler`` session and
    ``--dump-hlo DIR`` dumps every fresh CUDA-graph capture
    (``telemetry/profiling.py``); either implies the metrics registry,
    where the capture census lands.  With the registry on, the event-bus
    bridge (``telemetry/bridge.py``) is attached and returned, for
    ``finish_telemetry``; otherwise None."""
    from ..telemetry import metrics_registry, tracer
    from ..telemetry.bridge import attach_event_bridge

    watched = getattr(args, "metrics_port", None) is not None
    profile_out = getattr(args, "profile_out", None)
    dump_hlo = getattr(args, "dump_hlo", None)
    if getattr(args, "trace_out", None):
        tracer.service = "orchestrator"
        tracer.reset()
        tracer.enabled = True
    bridge = None
    if (
        getattr(args, "metrics_out", None) or watched or profile_out
        or dump_hlo
    ):
        metrics_registry.reset()
        metrics_registry.enabled = True
        # bus topics -> metrics: the runtime's per-computation counters
        bridge = attach_event_bridge()
    if profile_out or dump_hlo:
        from ..telemetry import start_profiling

        start_profiling(profile_dir=profile_out, hlo_dir=dump_hlo)
    pulse_out = getattr(args, "pulse_out", None)
    if pulse_out or watched:
        from ..telemetry.pulse import pulse

        pulse.reset()
        pulse.enabled = True
        if pulse_out:
            pulse.stream_open(pulse_out)
    return bridge


def finish_telemetry(args, bridge=None) -> None:
    """Export what the flags asked for and switch telemetry back off (in a
    ``finally``, so a failed solve still writes what it gathered).  The
    exports are independent, and an export error is reported on stderr,
    not raised: a bad trace path neither loses the metrics nor changes
    the command's exit code.  ``bridge`` is ``start_telemetry``'s."""
    from ..telemetry import metrics_registry, tracer

    if bridge is not None:
        bridge.detach()
    watched = getattr(args, "metrics_port", None) is not None
    if getattr(args, "pulse_out", None) or watched:
        from ..telemetry.pulse import pulse

        pulse.enabled = False
        pulse.stream_close()
    if getattr(args, "profile_out", None) or getattr(args, "dump_hlo", None):
        from ..telemetry import profiling, stop_profiling

        stop_profiling()
        if profiling.profiler_error:
            if profiling.profiler_error.startswith("stop_trace failed"):
                # the profiler ran; only the trace export failed
                print(
                    f"warning: device profiler trace export failed "
                    f"({profiling.profiler_error})",
                    file=sys.stderr,
                )
            else:
                print(
                    f"warning: device profiler unavailable "
                    f"({profiling.profiler_error}); the host-clock "
                    f"device.chunk_ms fallback was recorded instead",
                    file=sys.stderr,
                )
        metrics_registry.enabled = False
    if watched:
        metrics_registry.enabled = False
    if getattr(args, "metrics_out", None):
        metrics_registry.enabled = False
        try:
            metrics_registry.dump(args.metrics_out)
        except OSError as e:
            print(
                f"warning: could not write --metrics-out "
                f"{args.metrics_out}: {e}",
                file=sys.stderr,
            )
    if getattr(args, "trace_out", None):
        tracer.enabled = False
        try:
            if args.trace_out.endswith(".jsonl"):
                tracer.export_jsonl(args.trace_out)
            else:
                tracer.export_chrome(args.trace_out)
        except OSError as e:
            print(
                f"warning: could not write --trace-out "
                f"{args.trace_out}: {e}",
                file=sys.stderr,
            )
