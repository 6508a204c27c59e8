"""``pydcop_tpu_torch`` command line interface.

Counterpart of ``pydcop_tpu/dcop_cli.py``: argparse top level with the
global ``-t/--timeout`` (plus a grace slack), ``--strict_timeout``,
``-v`` verbosity, ``--log`` and ``--output``, and one sub-command module
per verb.  The port has the ``solve``, ``serve`` and ``capture`` verbs,
and the host-only ``generate``, ``checkpoints``, ``memplan``,
``postmortem``, ``telemetry``, ``watch``, ``fleet`` and ``router``
verbs and ``capture diff``, which import no torch (the router's spawned
workers are ``serve`` processes, given the router's ``--device``).  Its
global ``--device {cuda,cpu}`` takes the place of JAX's
``JAX_PLATFORMS``: the default is the card, and without one the CLI
exits nonzero unless ``--device cpu`` is given; it never falls back to
the CPU by itself.  The JAX CLI's multi-host and platform options are
parsed and refused as not ported.

Run as ``python -m pydcop_tpu_torch [--device cpu] solve -a ALGO FILE``,
``python -m pydcop_tpu_torch [--device cpu] serve --port 0`` or
``python -m pydcop_tpu_torch generate FAMILY ...``.
"""

from __future__ import annotations

import argparse
import logging
import logging.config
import signal
import sys
from typing import List, Optional

from .commands import (
    capture,
    checkpoints,
    fleet,
    generate,
    memplan,
    postmortem,
    router,
    serve,
    solve,
    telemetry,
    watch,
)

__all__ = ["main"]

# extra slack on top of --timeout before force-exit, so the command can
# finish its chunk and report TIMEOUT itself
TIMEOUT_SLACK = 20

# verbs that only read or write files on the host: they run without a card
_HOST_ONLY = ("checkpoints", "fleet", "generate", "memplan", "postmortem",
              "router", "telemetry", "watch")

# global options of the JAX CLI that the port does not run yet
_NOT_PORTED = (
    ("--coordinator", dict(default=None)),
    ("--num-hosts", dict(type=int, default=None)),
    ("--host-index", dict(type=int, default=None)),
    ("--local-devices", dict(type=int, default=None)),
    ("--platform", dict(default=None)),
    ("--platform-probe-timeout", dict(type=float, default=None)),
)


def _setup_logging(level: int, log_conf: Optional[str]) -> None:
    if log_conf:
        logging.config.fileConfig(log_conf, disable_existing_loggers=False)
        return
    levels = {
        0: logging.ERROR,
        1: logging.WARNING,
        2: logging.INFO,
        3: logging.DEBUG,
    }
    logging.basicConfig(
        level=levels.get(level, logging.DEBUG),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pydcop_tpu_torch",
        description="DCOP solving on an NVIDIA GPU (pyDCOP-compatible CLI)",
    )
    parser.add_argument(
        "-t", "--timeout", type=float, default=None,
        help="global timeout in seconds",
    )
    parser.add_argument(
        "--strict_timeout", action="store_true",
        help="exit immediately at timeout instead of finishing the cycle",
    )
    parser.add_argument(
        "-v", "--verbosity", type=int, default=0, help="0..3"
    )
    parser.add_argument("--log", default=None, help="logging config file")
    parser.add_argument(
        "--output", default=None, help="result file (default: stdout)"
    )
    parser.add_argument(
        "--version", action="version", version="pydcop_tpu_torch 0.1"
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where to solve: the card (default; refused when none is "
        "present) or the CPU",
    )
    for flag, kwargs in _NOT_PORTED:
        parser.add_argument(flag, help="not ported yet", **kwargs)

    subparsers = parser.add_subparsers(dest="command")
    solve.set_parser(subparsers)
    serve.set_parser(subparsers)
    generate.set_parser(subparsers)
    checkpoints.set_parser(subparsers)
    memplan.set_parser(subparsers)
    postmortem.set_parser(subparsers)
    telemetry.set_parser(subparsers)
    watch.set_parser(subparsers)
    fleet.set_parser(subparsers)
    router.set_parser(subparsers)
    capture.set_parser(subparsers)

    args = parser.parse_args(argv)
    _setup_logging(args.verbosity, args.log)

    if args.command is None:
        parser.print_help()
        return 2
    for flag, _kwargs in _NOT_PORTED:
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            print(f"error: {flag} is not ported yet", file=sys.stderr)
            return 2
    host_only = args.command in _HOST_ONLY or (
        args.command == "capture" and capture.is_diff_invocation(args)
    )
    if args.device == "cuda" and not host_only:
        import torch

        if not torch.cuda.is_available():
            print(
                "error: --device cuda (the default) but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "--device cpu to solve on the CPU",
                file=sys.stderr,
            )
            return 2

    def _on_sigint(sig, frame):
        print("interrupted", file=sys.stderr)
        sys.exit(130)

    signal.signal(signal.SIGINT, _on_sigint)

    if args.timeout:
        def _on_alarm(sig, frame):
            print("timeout", file=sys.stderr)
            sys.exit(124)

        signal.signal(signal.SIGALRM, _on_alarm)
        # strict: hard exit right at the timeout; default: grant slack so
        # the command can finish the cycle and report TIMEOUT itself
        grace = 0 if args.strict_timeout else TIMEOUT_SLACK
        signal.alarm(max(1, int(args.timeout) + grace))

    return args.func(args, timeout=args.timeout) or 0


if __name__ == "__main__":
    sys.exit(main())
