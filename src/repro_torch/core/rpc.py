"""Wire images of the multi-job service's engine snapshots.

The engine-snapshot schema version and the ``BOConfig`` wire image, which
``SelectionService.snapshot_job`` / ``restore_job`` write and read. The
images are the JAX package's (``repro.core.rpc``): a snapshot taken by
either package loads into the other. The backend names cross in the
reference's spelling — its ``"pallas"`` is this package's ``"kernel"``, its
``"xla"`` this package's ``"torch"`` — and are mapped on the way in and out.

The rest of the protocol (the typed request/reply messages, the JSON-line
codec, ``PROTOCOL_VERSION`` and the socket replicas) comes with ROADMAP
queue A item 11.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.gp.empirical_bayes import EmpiricalBayesConfig
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
from repro_torch.core.optimize_acq import AcqOptConfig
from repro_torch.core.suggest import BOConfig

__all__ = [
    "ENGINE_SNAPSHOT_VERSION",
    "bo_config_to_wire",
    "bo_config_from_wire",
]

#: Engine-snapshot schema version (``SelectionService.snapshot_job`` output),
#: the reference's: v5 carries the store's ``own_costs`` and the suggester's
#: ``budget`` ledger on jobs that track cost, v4 the ``multi_fidelity`` state
#: and the store's ``own_keys``, v3 the subset-backend and per-head cache
#: fields (always empty here: ROADMAP A10), v2 the metric block.
ENGINE_SNAPSHOT_VERSION = 5

# this package's backend names -> the reference's, and back
_TO_WIRE = {"kernel": "pallas", "torch": "xla"}
_FROM_WIRE = {wire: name for name, wire in _TO_WIRE.items()}

# the reference's subset-backend knobs, at its defaults (ROADMAP A10)
_N_SWITCH = 2048
_MAX_INDUCING = 1024


def bo_config_to_wire(cfg: BOConfig) -> Dict[str, Any]:
    """JSON-safe image of a ``BOConfig`` (nested NamedTuple configs flattened
    to field dicts), in the reference's schema. Round-trips through
    ``bo_config_from_wire`` to an equal config."""
    acq = cfg.acq._asdict()
    acq["backend"] = _TO_WIRE[acq["backend"]]
    return {
        "num_init": cfg.num_init,
        "gphp_method": cfg.gphp_method,
        "slice_config": cfg.slice_config._asdict(),
        "eb_config": cfg.eb_config._asdict(),
        "acq": acq,
        "pending_strategy": cfg.pending_strategy,
        "liar_value": cfg.liar_value,
        "dedupe_tol": cfg.dedupe_tol,
        "max_pending": cfg.max_pending,
        "refit_every": cfg.refit_every,
        "incremental": cfg.incremental,
        "fit_backend": _TO_WIRE[cfg.fit_backend],
        "num_scalarizations": cfg.num_scalarizations,
        "fantasy_block": cfg.fantasy_block,
        "posterior_backend": cfg.posterior_backend,
        "n_switch": _N_SWITCH,
        "max_inducing": _MAX_INDUCING,
        "per_head_gphp": cfg.per_head_gphp,
        "cost_aware": cfg.cost_aware,
        "cost_cooling": cfg.cost_cooling,
    }


def bo_config_from_wire(blob: Dict[str, Any]) -> BOConfig:
    """Inverse of ``bo_config_to_wire`` (this package's image or the JAX
    package's). The subset backend and per-head chains are refused by
    ``BOConfig`` itself (ROADMAP A10)."""
    acq = dict(blob["acq"])
    acq["backend"] = _FROM_WIRE[acq["backend"]]
    return BOConfig(
        num_init=int(blob["num_init"]),
        gphp_method=blob["gphp_method"],
        slice_config=SliceSamplerConfig(**blob["slice_config"]),
        eb_config=EmpiricalBayesConfig(**blob["eb_config"]),
        acq=AcqOptConfig(**acq),
        pending_strategy=blob["pending_strategy"],
        liar_value=float(blob["liar_value"]),
        dedupe_tol=float(blob["dedupe_tol"]),
        max_pending=int(blob["max_pending"]),
        refit_every=int(blob["refit_every"]),
        incremental=bool(blob["incremental"]),
        fit_backend=_FROM_WIRE[blob["fit_backend"]],
        num_scalarizations=int(blob.get("num_scalarizations", 16)),
        fantasy_block=bool(blob.get("fantasy_block", False)),
        posterior_backend=blob.get("posterior_backend", "exact"),
        per_head_gphp=bool(blob.get("per_head_gphp", False)),
        cost_aware=bool(blob.get("cost_aware", False)),
        cost_cooling=float(blob.get("cost_cooling", 1.0)),
    )
