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

__all__ = ["compiled_from_numpy", "ell_planes_from_numpy"]


def compiled_from_numpy(fields: Mapping[str, Any]) -> CompiledDCOP:
    """The port's ``CompiledDCOP`` from the fields of the JAX package's
    (``dataclasses.asdict``-style: buckets as mappings of their fields,
    domains as objects with ``name``, ``type`` and ``values``).  Only
    array-level problems carry over: an object-level ``dcop`` raises."""
    if fields.get("dcop") is not None:
        raise NotImplementedError(
            "compiled_from_numpy: object-level DCOPs are not ported yet"
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


def ell_planes_from_numpy(
    v2f: np.ndarray, f2v: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxSum's two ``[D, n_pad]`` ELL message planes as float32 tensors
    on ``device``."""
    return tuple(
        torch.as_tensor(np.asarray(p, dtype=np.float32), device=device)
        for p in (v2f, f2v)
    )
