"""``solve``: a static DCOP from YAML files, solved on the device.

Counterpart of ``pydcop_tpu/commands/solve.py``: load the problem,
solve it on the card (or the CPU with the global ``--device cpu``) and
print the result JSON, the same schema and the same text as the JAX
package's.  ``--mode direct`` (the default) compiles and solves with no
control plane; ``--mode thread`` and ``--mode process`` run the agent
runtime (``infrastructure/``: an orchestrator that owns the card and
solves the whole DCOP on it, agents in threads or in spawned processes
over HTTP, deployed by ``-d``), with ``-c``/``--period`` (how the
orchestrator collects), ``--delay`` and ``--uiport`` (thread mode's
agents; process mode warns and ignores them, as the JAX package does),
``--metrics-port`` (the orchestrator's live surface) and ``--port``
(process mode's ports, 9000 and up as in the JAX package; 0 binds free
ones).  ``--pulse-out`` streams the solve's
per-cycle health rows as JSONL (and arms the flight recorder, which
dumps ``postmortem.json`` when a ``--timeout`` runs out);
``--checkpoint``/``--resume`` and their cadence flags make the solve
durable, and ``--fault-schedule`` arms a schedule's process kills
(``kill_process``: ``os._exit`` at its time, the crash that a
``--resume`` recovers from) around the solve, as the JAX package's
direct mode does; ``--run_metrics``/``--end_metrics`` write the CSV
metrics; ``--trace-out`` writes the engine's window and read-back spans
as a Chrome trace (or JSONL for a ``.jsonl`` path) and ``--metrics-out``
the metrics registry's snapshot as JSON, with the JAX package's names.
``--profile-out DIR`` records a ``torch.profiler`` session of the solve
(CUDA kernels and CPU ops, with ``solve.{phase}.fused``/``.chunk``/
``.readback`` ranges) as a Chrome trace in ``DIR``, ``--dump-hlo DIR``
writes each fresh CUDA-graph capture as DOT, and the legacy ``--profile
DIR`` a bare session through TensorBoard's trace handler
(``telemetry/profiling.py``); the result is the same with or without
them.
``--metrics-port`` turns the registry and pulse on for the run; in
direct mode it logs the JAX package's warning (the live surface belongs
to the runtime's orchestrator, and direct mode starts no server).
``--mem-guard``, ``--mem-reserve-pct`` and ``--mem-limit-bytes`` arm the
memory guard: a solve predicted not to fit is refused before anything is
uploaded, with an ``ERROR`` result that carries the breach (``mem``).
In thread mode a ``--fault-schedule``'s agent kills crash agents, whose
computations are repaired as a scenario removal's, and its device
faults fail a device-solve attempt; its message rules are refused (exit
2, ROADMAP Queue 1 item 1), as is a ``-d`` method the port does not have
yet in the thread and process modes (exit 2, Queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import sys
import time

from ..dcop.yamldcop import load_dcop_from_file
from ._utils import (
    add_chaos_arguments,
    add_csvio_arguments,
    add_durability_arguments,
    add_memguard_arguments,
    add_runtime_arguments,
    add_telemetry_arguments,
    build_algo_def,
    build_chaos_controller,
    chaos_report,
    configure_memguard,
    finish_durability,
    finish_telemetry,
    start_durability,
    start_telemetry,
    write_output,
)

logger = logging.getLogger("pydcop_tpu_torch.cli.solve")

def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "solve", help="solve a static DCOP on the device"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    parser.add_argument(
        "-a", "--algo", required=True, help="algorithm name"
    )
    parser.add_argument(
        "-p",
        "--algo_params",
        action="append",
        default=None,
        help="algorithm parameter as name:value (repeatable)",
    )
    parser.add_argument(
        "-d",
        "--distribution",
        default="oneagent",
        help="distribution method (oneagent, adhoc) of the thread and "
        "process modes; reported in direct mode's result",
    )
    parser.add_argument(
        "-m",
        "--mode",
        choices=["direct", "thread", "process"],
        default="direct",
        help="direct = compiled device solve (fastest); thread/process = "
        "the agent runtime, its orchestrator solving on the device",
    )
    parser.add_argument(
        "-c",
        "--collect_on",
        choices=["value_change", "cycle_change", "period"],
        default="value_change",
    )
    parser.add_argument(
        "--period", type=float, default=None, help="for --collect_on period"
    )
    parser.add_argument(
        "-n", "--n_cycles", type=int, default=100,
        help="number of synchronous cycles to run",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--collect_curve", action="store_true",
        help="include the per-cycle cost curve in the result",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="legacy alias: bare torch.profiler trace of the solve to DIR "
        "(TensorBoard's trace handler); prefer --profile-out, which adds "
        "per-phase ranges and compile.* metrics",
    )
    parser.add_argument(
        "--port", type=int, default=9000,
        help="process mode: the orchestrator's HTTP port, the agents on "
        "the next ones (default 9000); 0 binds free ports",
    )
    add_csvio_arguments(parser)
    add_runtime_arguments(parser)
    add_telemetry_arguments(parser)
    add_chaos_arguments(parser)
    add_durability_arguments(parser)
    add_memguard_arguments(parser)


def _dump_run_metrics(path: str, curve, offset: int = 0) -> None:
    """Per-cycle cost CSV; ``offset`` is the absolute cycle the curve
    starts after (a ``--resume`` run's curve covers the resumed cycles
    only)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["cycle", "cost"])
        for i, c in enumerate(curve or []):
            w.writerow([offset + i + 1, c])


def run_cmd(args, timeout: float = None) -> int:
    from ..infrastructure.run import distribution_refusal, fault_refusal

    chaos = None
    refusal = None
    if args.mode != "direct":
        refusal = distribution_refusal(args.distribution)
    if args.mode == "thread" and refusal is None:
        # load the schedule before anything starts: a refused one exits
        # 2 with no telemetry or checkpoint side effects
        chaos = build_chaos_controller(args)
        refusal = fault_refusal(chaos)
    if refusal is not None:
        print(f"error: solve: {refusal}", file=sys.stderr)
        return 2
    bridge = start_telemetry(args)
    manager = start_durability(args)
    configure_memguard(args)
    try:
        return _run_cmd(args, timeout, chaos)
    finally:
        # a failed or timed-out solve keeps the checkpoints it wrote
        finish_durability(args, manager)
        finish_telemetry(args, bridge)


def _arm_process_kills(args):
    """The --fault-schedule controller with its timeline started, or None
    when the schedule has no process kill.  Agent kills, message rules
    and device faults need the agent runtime: logged and ignored."""
    chaos = build_chaos_controller(args)
    if chaos is None:
        return None
    sched = chaos.schedule
    if sched.kills or sched.rules or sched.device_faults:
        logger.warning(
            "--fault-schedule: agent kills / message rules / device "
            "faults need the agent runtime; direct mode ignores them"
        )
    if not sched.process_kills:
        return None
    # whole-process kills need no agents: arm the timeline around the
    # device solve
    chaos.start(None)
    return chaos


def _run_cmd(args, timeout: float = None, chaos=None) -> int:
    t_load = time.perf_counter()
    dcop = load_dcop_from_file(args.dcop_files)
    logger.info(
        "loaded %s in %.3fs", args.dcop_files,
        time.perf_counter() - t_load,
    )
    algo_def = build_algo_def(
        args.algo, args.algo_params, mode=dcop.objective
    )
    from ..api import solve_result
    from ..telemetry.memplane import MemoryBudgetExceeded

    profile_ctx = contextlib.nullcontext()
    if args.mode == "process" and (args.profile_out or args.dump_hlo):
        logger.warning(
            "--profile-out/--dump-hlo instrument this process; --mode "
            "process runs its agents in child processes, which never "
            "solve: the device timeline is this process's, the "
            "orchestrator's"
        )
    if args.profile and args.profile_out:
        # start_telemetry already opened a profiler session; a second
        # one would fail mid-solve
        logger.warning(
            "--profile ignored: --profile-out is already recording a "
            "device timeline to %s", args.profile_out,
        )
    elif args.profile:
        import torch

        if args.mode == "process":
            logger.warning(
                "--profile instruments this process only; --mode process "
                "runs its agents in child processes (the solve is this "
                "process's, the orchestrator's)"
            )
        acts = [torch.profiler.ProfilerActivity.CPU]
        if args.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile_ctx = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.profile
            ),
        )
    if args.mode != "direct":
        with profile_ctx:
            result = _runtime_solve(args, dcop, algo_def, timeout, chaos)
        return _report(args, result)
    if args.delay is not None or args.uiport is not None:
        logger.warning(
            "--delay/--uiport shape the agent runtime; direct mode has no "
            "agents: use --mode thread to observe a run through the UI"
        )
    chaos = _arm_process_kills(args)
    if args.metrics_port is not None:
        logger.warning(
            "--metrics-port serves the orchestrator's live surface; direct "
            "mode has no orchestrator: use --mode thread (metrics are "
            "still collected and dumped via --metrics-out)"
        )
    try:
        with profile_ctx:
            result = solve_result(
                dcop,
                algo_def,
                distribution=args.distribution,
                n_cycles=args.n_cycles,
                seed=args.seed,
                collect_curve=bool(args.collect_curve or args.run_metrics),
                timeout=timeout,
                infinity=args.infinity,
                device=args.device,
            )
    except MemoryBudgetExceeded as e:
        # the guard's refusal, before anything was uploaded: its numbers
        # in the result, as the JAX package's CLI writes them
        logger.error("%s", e)
        result = {"status": "ERROR", "error": str(e), "mem": e.breach}
    if chaos is not None:
        # the fault timeline is part of the run: a process kill due at t
        # fires even when the solve returned early, or the same schedule
        # would exercise different faults depending on machine speed
        pending = max(
            (k.at for k in chaos.schedule.process_kills), default=0.0
        )
        chaos.wait_timeline(timeout=pending + 10.0)
        chaos.stop()
    return _report(args, result)


def _report(args, result) -> int:
    """Write the CSV metrics and the result JSON; the exit code."""
    if args.run_metrics:
        offset = 0
        if getattr(args, "resume", None):
            # a resumed solve's curve starts at the checkpoint's cycle:
            # label the CSV in absolute cycles
            from ..durability import durability

            offset = int(
                (durability.last_resume or {}).get("cycle") or 0
            )
        _dump_run_metrics(
            args.run_metrics, result.get("cost_curve"), offset
        )
    if not args.collect_curve:
        result.pop("cost_curve", None)
    if args.end_metrics:
        exists = os.path.exists(args.end_metrics)
        with open(args.end_metrics, "a", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            if not exists:
                w.writerow(
                    ["time", "status", "cost", "violation", "cycle",
                     "msg_count", "msg_size"]
                )
            w.writerow(
                [result.get(k) for k in
                 ("time", "status", "cost", "violation", "cycle",
                  "msg_count", "msg_size")]
            )
    write_output(args, result)
    # TIMEOUT exits 0: the anytime incumbent is a usable result
    return 0 if result.get("status") in ("FINISHED", "TIMEOUT") else 1


def _runtime_solve(args, dcop, algo_def, timeout, chaos):
    """The thread and process modes: the agent runtime, its orchestrator
    solving on ``args.device``; the result is ``end_metrics()``."""
    from ..infrastructure.run import (
        run_local_process_dcop,
        run_local_thread_dcop,
    )

    extra = {}
    if args.metrics_port is not None:
        extra["metrics_port"] = args.metrics_port
    if args.mode == "thread":
        runner = run_local_thread_dcop
        if args.uiport is not None:
            extra["ui_port"] = args.uiport
        if args.delay is not None:
            extra["delay"] = args.delay
        if chaos is not None:
            extra["chaos"] = chaos
    else:
        runner = run_local_process_dcop
        extra["port"] = args.port
        if args.delay is not None or args.uiport is not None:
            logger.warning(
                "--delay/--uiport are thread-mode options; process-mode "
                "agents ignore them"
            )
        if args.fault_schedule:
            logger.warning(
                "--fault-schedule requires in-process agents; "
                "process-mode runs ignore it (use --mode thread)"
            )
        if args.trace_out:
            # one trace per process: the parent keeps --trace-out, each
            # agent process writes <trace_out>.<agent>.json; merge them
            # with the telemetry stitch verb
            extra["trace_out"] = args.trace_out
    orchestrator = runner(
        algo_def,
        dcop,
        args.distribution,
        n_cycles=args.n_cycles,
        seed=args.seed,
        collect_moment=args.collect_on,
        collect_period=args.period,
        infinity=args.infinity,
        device=args.device,
        **extra,
    )
    try:
        # process-mode agents are spawned interpreters that import the
        # runtime before their loop runs (no torch: about a second each,
        # concurrently), so the registration wait scales with the agent
        # count as the JAX package's does
        register_s = 10.0
        if args.mode == "process":
            register_s = max(60.0, 5.0 * len(dcop.agents))
            if timeout:
                register_s = min(register_s, timeout)
        t_reg = time.perf_counter()
        orchestrator.deploy_computations(timeout=register_s)
        # --timeout is a wall-clock bound on the whole command:
        # registration spends from the same budget the run gets
        remaining = (
            None if timeout is None
            else max(1.0, timeout - (time.perf_counter() - t_reg))
        )
        orchestrator.run(timeout=remaining)
        metrics = orchestrator.end_metrics()
        metrics.pop("repair_metrics", None)
        if chaos is not None:
            metrics["chaos"] = chaos_report(chaos, orchestrator)
        agent_traces = getattr(orchestrator, "_agent_trace_files", None)
        if agent_traces:
            # the per-process trace files, so the stitch step is
            # discoverable from the result itself
            metrics["agent_trace_files"] = agent_traces
        return metrics
    finally:
        try:
            orchestrator.stop_agents()
        finally:
            orchestrator.stop()
            # process mode: wait for the (daemon) agent processes to
            # flush their per-agent trace files before this process
            # exits; name a straggler, whose trace may be truncated
            stragglers = []
            for p in getattr(orchestrator, "_agent_processes", []):
                p.join(timeout=5.0)
                if p.is_alive():
                    stragglers.append(p.name)
            if stragglers:
                logger.warning(
                    "agent process(es) %s still running at exit; their "
                    "per-agent trace files may be truncated or missing",
                    stragglers,
                )
            agent_traces = getattr(
                orchestrator, "_agent_trace_files", None
            )
            if agent_traces:
                logger.info(
                    "per-agent traces written; merge with: "
                    "python -m pydcop_tpu_torch telemetry stitch %s %s "
                    "-o merged.json",
                    args.trace_out, " ".join(agent_traces),
                )
