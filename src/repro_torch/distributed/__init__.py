"""The cross-process selection-service harness: engine replicas that serve
a ``SelectionService`` over sockets with leases (``EngineServer``), and the
leasing client that a ``Tuner`` drives like the in-process service
(``RemoteService``), with snapshot-based failover between replicas.

The JAX package's ``repro.distributed`` also holds the model-sharding
helpers (``sharding.py``); their port is a later item (ROADMAP A13), so this
package exports the harness only. The names load lazily, so
``python -m repro_torch.distributed.engine_server`` runs its module once.
"""

__all__ = [
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
