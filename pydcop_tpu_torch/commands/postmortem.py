"""``pydcop_tpu_torch postmortem``: render a flight-recorder dump.

Counterpart of the JAX package's ``postmortem`` verb.  A solve with pulse
on (``--pulse-out``) arms the flight recorder, a bounded ring of the last
per-cycle health vectors and the run's configuration fingerprint, which
dumps ``postmortem.json`` when the solve's ``--timeout`` runs out.  This
verb prints the dump's diagnosis timeline: a diagnosis per window
(converged, stalled-plateau, oscillating(period=k), still-improving),
the overall verdict and the frozen-vs-churning summary.  Host-only; it
reads the dumps of either package.
"""

from __future__ import annotations

import logging
import sys

from ..telemetry.pulse import load_postmortem, render_postmortem
from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.postmortem")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "postmortem",
        help="render a postmortem.json diagnosis timeline",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "file", help="postmortem.json written by the flight recorder"
    )
    parser.add_argument(
        "--window", type=int, default=16,
        help="cycles per diagnosis-timeline row (default 16)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the parsed document (with its diagnosis) as JSON "
        "instead of the rendered timeline",
    )
    parser.add_argument(
        "--output", default=None, help="write to this file instead of stdout"
    )


def run_cmd(args, timeout: float = None) -> int:
    try:
        doc = load_postmortem(args.file)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.as_json:
        write_output(args, doc)
        return 0
    text = render_postmortem(doc, window=max(1, args.window))
    output = getattr(args, "output", None)
    if output:
        with open(output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0
