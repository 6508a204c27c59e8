"""Checkpoint and resume of solver state, in the JAX package's npz format.

Counterpart of the npz half of ``pydcop_tpu/utils/checkpoint.py``: a tree
of arrays (tensors, numpy arrays, named tuples, dataclasses, tuples,
lists and dicts, whose keys go in sorted order as JAX's tree flattening
takes them; ``None`` is no leaf) is written as one ``.npz`` file with
arrays ``leaf_0`` ... ``leaf_{n-1}`` in tree order and a ``__meta__`` array
holding the UTF-8 JSON ``{"n_leaves", "treedef", "metadata",
"leaf_dtypes"}``.  A bfloat16 leaf, which npz cannot hold, is stored as
its ``uint8`` view and named in ``leaf_dtypes``; it comes back as a
``torch.bfloat16`` view of the same bytes.  So a checkpoint written by
either package loads in the other.  Loaded leaves are CPU tensors.

The port has no orbax: ``save_checkpoint(use_orbax=True)`` writes npz, as
the JAX package does when orbax is missing, and loading an orbax
checkpoint directory raises :class:`CheckpointError`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("pydcop_tpu_torch.checkpoint")

__all__ = [
    "save_checkpoint", "load_checkpoint", "CheckpointError",
    "atomic_write_json",
]


class CheckpointError(Exception):
    pass


def atomic_write_json(path: str, obj: Any, **json_kwargs: Any) -> None:
    """Write ``obj`` as JSON to ``path`` through a temporary file and
    ``os.replace``: a crash mid-write leaves the previous file or none,
    never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, **json_kwargs)
        f.write("\n")
    os.replace(tmp, path)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float))


def _flatten(tree) -> Tuple[List[Any], str]:
    """The array leaves of ``tree`` in order, and a description of its
    structure (kept in the file for a reader, compared on load)."""
    if tree is None:
        return [], "None"
    if _is_leaf(tree):
        return [tree], "*"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        children = [getattr(tree, n) for n in names]
        label = type(tree).__name__
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        names, children, label = list(tree._fields), list(tree), (
            type(tree).__name__
        )
    elif isinstance(tree, (tuple, list)):
        names, children, label = None, list(tree), type(tree).__name__
    elif isinstance(tree, dict):
        names = sorted(tree)
        children, label = [tree[n] for n in names], "dict"
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    leaves, parts = [], []
    for child in children:
        sub, desc = _flatten(child)
        leaves += sub
        parts.append(desc)
    if names is not None:
        parts = [f"{n}={p}" for n, p in zip(names, parts)]
    return leaves, f"{label}({', '.join(parts)})"


def _unflatten(tree, leaves):
    """``tree`` with its array leaves replaced, in order, from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return next(leaves)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    items = [_unflatten(x, leaves) for x in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the numpy array npz stores, and the dtype name to record
    when that array is a bit view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy(), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def save_checkpoint(
    path: str,
    state: Any,
    metadata: Optional[Dict[str, Any]] = None,
    use_orbax: bool = False,
) -> None:
    """Write a tree of arrays to ``path`` (npz; ``use_orbax`` too, as the
    port has no orbax).  The write is atomic: a crash leaves the previous
    file or none."""
    leaves, treedef = _flatten(state)
    leaf_dtypes: Dict[str, str] = {}
    arrays = {}
    for i, leaf in enumerate(leaves):
        arr, viewed = _to_numpy(leaf)
        if viewed is not None:
            leaf_dtypes[str(i)] = viewed
        arrays[f"leaf_{i}"] = arr
    arrays["__meta__"] = np.frombuffer(
        json.dumps({
            "n_leaves": len(leaves),
            "treedef": treedef,
            "metadata": metadata or {},
            "leaf_dtypes": leaf_dtypes,
        }).encode("utf-8"),
        dtype=np.uint8,
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _identity_note(metadata: Dict[str, Any]) -> str:
    """What the checkpoint says it belongs to, for mismatch errors."""
    if not isinstance(metadata, dict):
        return ""
    parts = []
    if metadata.get("algo"):
        parts.append(f"algo={metadata['algo']}")
    if metadata.get("fingerprint"):
        parts.append(f"problem fingerprint={metadata['fingerprint']}")
    if metadata.get("n_vars") is not None:
        parts.append(f"n_vars={metadata['n_vars']}")
    return f" (checkpoint identity: {', '.join(parts)})" if parts else ""


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(leaf).dtype)).dtype


def _validate_leaves(leaves, like_leaves, metadata, path) -> None:
    note = _identity_note(metadata)
    if len(like_leaves) != len(leaves):
        raise CheckpointError(
            f"checkpoint {path} has {len(leaves)} leaves, template has "
            f"{len(like_leaves)}{note}"
        )
    for i, (stored, tmpl) in enumerate(zip(leaves, like_leaves)):
        t_shape = tuple(getattr(tmpl, "shape", np.shape(tmpl)))
        t_dtype = _torch_dtype(tmpl)
        if tuple(stored.shape) != t_shape or stored.dtype != t_dtype:
            raise CheckpointError(
                f"leaf {i} mismatch: checkpoint {tuple(stored.shape)}/"
                f"{stored.dtype} vs template {t_shape}/{t_dtype}{note}"
            )


def load_checkpoint(path: str, like: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Read a checkpoint.  With ``like`` (a tree of the same structure),
    returns (the tree with the stored leaves, metadata), each leaf
    checked against the template's shape and dtype; without, (the list of
    leaves, metadata).  Leaves are CPU tensors."""
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at {path}")
    if os.path.isdir(path):
        raise CheckpointError(
            f"{path} is an orbax checkpoint directory: reading orbax "
            "checkpoints is not ported"
        )
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        arrays = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    leaves = [torch.from_numpy(np.array(a, order="C")) for a in arrays]
    for i_str, dtype_name in meta.get("leaf_dtypes", {}).items():
        if dtype_name != "bfloat16":
            raise CheckpointError(
                f"leaf {i_str} of {path} has dtype {dtype_name}, which the "
                "port does not read"
            )
        leaves[int(i_str)] = leaves[int(i_str)].view(torch.bfloat16)
    metadata = meta.get("metadata", {})
    if like is None:
        return leaves, metadata
    like_leaves, treedef = _flatten(like)
    _validate_leaves(leaves, like_leaves, metadata, path)
    if meta.get("treedef") not in (None, treedef):
        # the other package, or another version, describes the structure
        # in its own words; shapes and dtypes were checked leaf by leaf
        logger.debug(
            "checkpoint tree description differs from the template's "
            "(leaf shapes and dtypes match): %s vs %s",
            meta.get("treedef"), treedef,
        )
    return _unflatten(like, iter(leaves)), metadata
