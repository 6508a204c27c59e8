"""Carry a problem and message planes over from the JAX package's form.

A ``CompiledDCOP`` is the DCOP's counterpart of a model's weights: built
once, it lets both packages solve the very same arrays.  These functions
take it, and MaxSum message planes, as plain numpy arrays, lists and ints,
so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from .compile.core import ArityBucket, CompiledDCOP
from .dcop.objects import Domain

__all__ = ["compiled_from_numpy", "planes_from_numpy"]


def compiled_from_numpy(fields: Mapping[str, Any]) -> CompiledDCOP:
    """The port's ``CompiledDCOP`` from the fields of the JAX package's
    (``dataclasses.asdict``-style: buckets as mappings of their fields,
    domains as objects with ``name``, ``type`` and ``values``).  Only
    array-level problems carry over as arrays: an object-level ``dcop``
    raises; carry it as YAML text (``dcop_yaml``, then the port's
    ``load_dcop``) and compile it with the port's ``compile_dcop``."""
    if fields.get("dcop") is not None:
        raise NotImplementedError(
            "compiled_from_numpy carries arrays only: carry an object-level "
            "DCOP across as YAML text and compile it with compile_dcop"
        )
    buckets = [
        ArityBucket(
            arity=int(b["arity"]),
            tables=np.asarray(b["tables"]),
            var_slots=np.asarray(b["var_slots"]),
            edge_ids=np.asarray(b["edge_ids"]),
            con_ids=np.asarray(b["con_ids"]),
            names=list(b["names"]),
        )
        for b in fields["buckets"]
    ]
    return CompiledDCOP(
        objective=str(fields["objective"]),
        var_names=list(fields["var_names"]),
        var_index=dict(fields["var_index"]),
        domains=[Domain(d.name, d.type, d.values) for d in fields["domains"]],
        n_vars=int(fields["n_vars"]),
        max_domain=int(fields["max_domain"]),
        domain_size=np.asarray(fields["domain_size"]),
        valid_mask=np.asarray(fields["valid_mask"]),
        unary=np.asarray(fields["unary"]),
        constant_cost=float(fields["constant_cost"]),
        buckets=buckets,
        n_edges=int(fields["n_edges"]),
        edge_var=np.asarray(fields["edge_var"]),
        edge_con=np.asarray(fields["edge_con"]),
        var_degree=np.asarray(fields["var_degree"]),
        con_names=list(fields["con_names"]),
        float_dtype=fields.get("float_dtype", np.float32),
    )


def planes_from_numpy(
    v2f: np.ndarray, f2v: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxSum's two message planes as float32 tensors on ``device``, in
    the layout they come in: ``[D, n_pad]`` (ELL), ``[D, n_edges]``
    (lanes) or ``[n_edges, D]`` (edges)."""
    return tuple(
        torch.as_tensor(np.asarray(p, dtype=np.float32), device=device)
        for p in (v2f, f2v)
    )
