"""YAML IO for replica distributions.

The port's copy of ``pydcop_tpu/replication/yamlformat.py``: the same
``replica_dist`` document, dumped by the same ``yaml.dump`` call.
"""

from __future__ import annotations

import yaml

from .objects import ReplicaDistribution

__all__ = ["load_replica_dist", "load_replica_dist_from_file", "yaml_replica_dist"]


def load_replica_dist(dist_str: str) -> ReplicaDistribution:
    data = yaml.safe_load(dist_str)
    if not isinstance(data, dict) or "replica_dist" not in data:
        raise ValueError("invalid replica distribution: no replica_dist key")
    return ReplicaDistribution(data["replica_dist"])


def load_replica_dist_from_file(filename: str) -> ReplicaDistribution:
    with open(filename, encoding="utf-8") as f:
        return load_replica_dist(f.read())


def yaml_replica_dist(dist: ReplicaDistribution) -> str:
    return yaml.dump({"replica_dist": dist.mapping}, default_flow_style=False)
