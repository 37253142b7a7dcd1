"""Distributed runtime: the model-sharding helpers (logical-axis rules on
DTensor, ``sharding.py``) and the cross-process selection-service harness:
engine replicas that serve a ``SelectionService`` over sockets with leases
(``EngineServer``), and the leasing client that a ``Tuner`` drives like the
in-process service (``RemoteService``), with snapshot-based failover between
replicas.

The sharding helpers are exported eagerly, as the JAX package exports
them; the harness loads lazily, so ``python -m
repro_torch.distributed.engine_server`` runs its module once.
"""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    logical_to_spec,
    spec_to_placements,
    tree_specs_to_shardings,
)

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "logical_to_spec",
    "spec_to_placements",
    "tree_specs_to_shardings",
    "EngineServer",
    "MirroredStore",
    "RemoteJobHandle",
    "RemoteService",
    "RemoteServiceError",
    "RemoteSuggester",
    "ReplicaDivergenceError",
]

_LAZY = {
    "EngineServer": "repro_torch.distributed.engine_server",
    "MirroredStore": "repro_torch.distributed.engine_client",
    "RemoteJobHandle": "repro_torch.distributed.engine_client",
    "RemoteService": "repro_torch.distributed.engine_client",
    "RemoteServiceError": "repro_torch.distributed.engine_client",
    "RemoteSuggester": "repro_torch.distributed.engine_client",
    "ReplicaDivergenceError": "repro_torch.distributed.engine_client",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
