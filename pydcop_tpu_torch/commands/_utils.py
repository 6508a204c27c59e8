"""Shared helpers for CLI commands.

Counterpart of ``pydcop_tpu/commands/_utils.py`` (the part the ``solve``
verb uses): parse ``--algo_params name:value`` pairs into a validated
``AlgorithmDef`` and write the JSON result.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..algorithms import AlgorithmDef

__all__ = ["build_algo_def", "parse_params", "write_output"]


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
