"""``memplan``: device memory planning without a card.

Counterpart of ``pydcop_tpu/commands/memplan.py``.  The model in
``telemetry/memplane.py`` predicts the bytes a solve of the port holds on
one device (the problem's tensors, the algorithm's constants and state,
the anytime carry, the workspace measured on the card), so capacity
questions are answered from headline numbers alone:

- ``memplan -a maxsum --n-vars 100000 --domain 3 --degree 4 --device
  h100`` gives the breakdown by component and a FITS/REFUSE verdict
  against that card's memory minus the reserve;
- ``memplan problem.yaml -a mgm2`` does the same for the exact compiled
  shape of a problem file;
- ``--max-vars``: the largest n_vars a device holds for the algorithm at
  this domain and degree; ``--max-batch-k``: the largest serving batch K
  whose bucket still fits.

Host only: no device is touched (``--device`` names a card of the
model's table, ``memplane.DEVICE_GENERATIONS``).
"""

from __future__ import annotations

import sys

from ._utils import write_output


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "memplan",
        help="predict the device memory of a solve, plan capacity",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "dcop_files", nargs="*", default=[],
        help="dcop yaml file(s): compile for the exact problem shape "
        "(omit to describe the shape with --n-vars/--domain/--degree)",
    )
    parser.add_argument(
        "-a", "--algo", default="maxsum", help="algorithm name"
    )
    parser.add_argument(
        "-p", "--algo_params", action="append", default=None,
        help="algorithm parameter as name:value (repeatable); "
        "layout:lanes prices MaxSum's lanes layout",
    )
    parser.add_argument(
        "--n-vars", type=int, default=None,
        help="synthetic shape: number of variables",
    )
    parser.add_argument(
        "--domain", type=int, default=None,
        help="synthetic shape: domain size D",
    )
    parser.add_argument(
        "--degree", type=float, default=4.0,
        help="synthetic shape: mean constraint degree (default 4)",
    )
    parser.add_argument(
        "--float-bytes", type=int, default=4, choices=(2, 4, 8),
        help="bytes per table/message element (default 4 = float32)",
    )
    parser.add_argument(
        "--mesh", type=int, default=1,
        help="devices the problem's rows split across (default 1)",
    )
    parser.add_argument(
        "--batch-k", type=int, default=1,
        help="serving batch size sharing one problem (default 1)",
    )
    parser.add_argument(
        "--n-cycles", type=int, default=64,
        help="cycles (sizes the pulse/curve carries; default 64)",
    )
    parser.add_argument(
        "--device", default=None, metavar="KIND", dest="device_kind",
        help="the card to budget against, by name (h100, 'h100 pcie', "
        "h200, a100 ...: the model's device table); default: no limit, "
        "the breakdown only",
    )
    parser.add_argument(
        "--limit-bytes", type=int, default=None,
        help="explicit per-device byte limit (overrides --device)",
    )
    parser.add_argument(
        "--reserve-pct", type=float, default=10.0,
        help="percent of the limit kept free (default 10)",
    )
    parser.add_argument(
        "--serve-bucket", action="store_true",
        help="budget the pow2 serving bucket this shape lands in, not "
        "the exact shape (what the serve admission guard charges)",
    )
    parser.add_argument(
        "--max-vars", action="store_true",
        help="answer: largest n_vars per device for this algo at "
        "--domain/--degree under the limit (needs --device or "
        "--limit-bytes)",
    )
    parser.add_argument(
        "--max-batch-k", action="store_true",
        help="answer: largest serving batch K of this shape's bucket "
        "under the limit (needs --device or --limit-bytes)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the plan as JSON instead of a table",
    )


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024.0
    return f"{n:.2f} GiB"


def _resolve_limit(args) -> tuple:
    """(limit_bytes, label) from --limit-bytes / --device, or (None,
    None); (None, "unknown") for a card the table does not have."""
    from ..telemetry.memplane import DEVICE_GENERATIONS, device_generation

    if args.limit_bytes is not None:
        return int(args.limit_bytes), "explicit"
    if args.device_kind:
        row = device_generation(args.device_kind)
        if row is None:
            known = ", ".join(repr(r[0]) for r in DEVICE_GENERATIONS)
            print(
                f"error: unknown device {args.device_kind!r} (known: "
                f"{known})", file=sys.stderr,
            )
            return None, "unknown"
        return row[2], row[0]
    return None, None


def run_cmd(args, timeout: float = None) -> int:
    from ..telemetry.memplane import (
        max_batch_k,
        max_vars_per_device,
        predict_solve_bytes,
        shape_of,
        synthetic_shape,
    )
    from ._utils import build_algo_def

    params = {}
    if args.algo_params:
        algo_def = build_algo_def(args.algo, args.algo_params, mode="min")
        params = dict(algo_def.params or {})

    limit, limit_label = _resolve_limit(args)
    if limit is None and limit_label == "unknown":
        return 2

    # the shape: exact (a compiled file) or synthetic (headline numbers)
    compiled = None
    shape = None
    if args.dcop_files:
        from ..compile.core import compile_dcop
        from ..dcop.yamldcop import load_dcop_from_file

        compiled = compile_dcop(load_dcop_from_file(args.dcop_files))
        shape = shape_of(compiled)
    elif args.n_vars is not None and args.domain is not None:
        shape = synthetic_shape(
            args.n_vars, args.domain, degree=args.degree,
            float_bytes=args.float_bytes,
        )
    elif not (args.max_vars or args.max_batch_k):
        print(
            "error: describe the problem — dcop yaml file(s), or "
            "--n-vars with --domain", file=sys.stderr,
        )
        return 2

    out = {
        "algo": args.algo,
        "limit_bytes": limit,
        "device": limit_label,
        "reserve_pct": args.reserve_pct,
    }
    pred = None
    if shape is not None:
        pred = predict_solve_bytes(
            compiled, args.algo, params, shape=shape,
            mesh=args.mesh, batch_k=args.batch_k, n_cycles=args.n_cycles,
            serve_bucket=args.serve_bucket,
        )
        out["plan"] = pred
        if limit is not None:
            budget = limit * (1.0 - args.reserve_pct / 100.0)
            fits = pred["per_device_bytes"] <= budget
            out["budget_bytes"] = int(budget)
            out["fits"] = fits
            out["headroom_pct"] = round(
                100.0 * (1.0 - pred["per_device_bytes"] / limit), 2
            )

    # the two capacity answers (they need a limit)
    if args.max_vars or args.max_batch_k:
        if limit is None:
            print(
                "error: --max-vars/--max-batch-k need --device or "
                "--limit-bytes", file=sys.stderr,
            )
            return 2
        if args.domain is None:
            print(
                "error: --max-vars/--max-batch-k need --domain",
                file=sys.stderr,
            )
            return 2
        if args.max_vars:
            out["max_vars_per_device"] = max_vars_per_device(
                args.algo, args.domain, args.degree, limit,
                reserve_pct=args.reserve_pct, params=params,
                float_bytes=args.float_bytes,
            )
        if args.max_batch_k:
            if args.n_vars is None:
                print(
                    "error: --max-batch-k needs --n-vars (the "
                    "per-tenant shape)", file=sys.stderr,
                )
                return 2
            out["max_batch_k"] = max_batch_k(
                args.algo, args.domain, args.n_vars, args.degree, limit,
                reserve_pct=args.reserve_pct, params=params,
                float_bytes=args.float_bytes,
            )

    if args.as_json:
        write_output(args, out)
        return 0

    if pred is not None:
        s = pred["shape"]
        print(
            f"memplan — algo {pred['algo']} "
            f"(family {pred['family']}, layout {pred['layout']})"
        )
        print(
            f"shape: {s['n_vars']} vars, domain {s['max_domain']}, "
            f"{s['n_edges']} edges, {s['n_constraints']} constraints"
        )
        if args.mesh != 1 or args.batch_k != 1:
            print(f"mesh: {args.mesh} devices, batch K {args.batch_k}")
        print(f"\n{'component':<16} {'bytes':>16} {'human':>12}")
        for name, b in sorted(
            pred["components"].items(), key=lambda kv: -kv[1]
        ):
            if not b:
                continue
            print(f"{name:<16} {b:>16d} {_fmt_bytes(b):>12}")
        print(
            f"{'per-device':<16} {pred['per_device_bytes']:>16d} "
            f"{_fmt_bytes(pred['per_device_bytes']):>12}"
        )
        print(f"dominant component: {pred['dominant']}")
        if limit is not None:
            print(
                f"\ndevice {limit_label}: limit {_fmt_bytes(limit)}, "
                f"reserve {args.reserve_pct:g}% -> budget "
                f"{_fmt_bytes(out['budget_bytes'])}"
            )
            verdict = "FITS" if out["fits"] else "REFUSE"
            print(
                f"verdict: {verdict} (headroom {out['headroom_pct']:g}%)"
            )
    if "max_vars_per_device" in out:
        print(
            f"max vars/device ({args.algo}, D={args.domain}, "
            f"degree {args.degree:g}): {out['max_vars_per_device']}"
        )
    if "max_batch_k" in out:
        print(
            f"max batch-K ({args.algo}, D={args.domain}, "
            f"{args.n_vars} vars): {out['max_batch_k']}"
        )
    return 0
