"""Multi-metric decision subsystem: constrained + Pareto tuning on
shared-factor multi-output GPs.

Public surface:
    MetricSpec / MetricSet           — declaring a job's named metrics
    constrained_ei / scalarized_ei /
    feasibility_weight               — closed-form multi-head acquisitions
    pareto_mask / hypervolume        — front tracking + scoring

The GP layer lives in ``repro_torch.core.gp.multi``
(``MultiOutputPosterior``); the engine integration in
``repro_torch.core.suggest`` (M>1 decision path); the workflow surface in
``repro_torch.core.tuner`` (``TuningJobConfig.metrics``,
``TuningResult.pareto_front``).
"""

from repro_torch.core.multimetric.spec import MetricSet, MetricSpec
from repro_torch.core.multimetric.acquisition import (
    constrained_ei,
    feasibility_weight,
    scalarized_ei,
)
from repro_torch.core.multimetric.pareto import hypervolume, pareto_mask

__all__ = [
    "MetricSpec",
    "MetricSet",
    "constrained_ei",
    "feasibility_weight",
    "scalarized_ei",
    "pareto_mask",
    "hypervolume",
]
