"""Core of the port: search space, observation store, BO engine, tuner.

The decision loop of the JAX reference (``repro.core``) in PyTorch:
single-metric, multi-metric (constrained and Pareto), cost-aware and
multi-fidelity jobs, with budgets; the early-stopping rules (median rule,
ASHA); MAP-II or slice-sampled GPHPs; and the multi-job selection service
(GPHP pool, factor arena, sibling warm start, engine snapshots). Unlike
the reference's package, importing this one flips no global switch: every
tensor names its dtype (float64 for the GP/BO numerics) and its device.
The socket replicas live in ``repro_torch.distributed``.

Public API:
    SearchSpace / Continuous / Integer / Categorical   (§4.1, §5.1)
    BOSuggester / RandomSuggester / SobolSuggester     (§4, §2.1)
    MedianRule                                         (§5.2)
    WarmStartPool                                      (§5.3)
    ASHARule                                           (beyond-paper, §2.3)
    Tuner / TuningJobConfig                            (§3 workflow engine)
    SelectionService / ServiceConfig                   (§3 multi-job service)
"""

from repro_torch.core.search_space import (
    Categorical,
    Continuous,
    Integer,
    ScalingType,
    SearchSpace,
)
from repro_torch.core.budget import BudgetExhaustedError, BudgetLedger
from repro_torch.core.history import ObservationStore
from repro_torch.core.multimetric import (
    MetricSet,
    MetricSpec,
    hypervolume,
    pareto_mask,
)
from repro_torch.core.suggest import (
    BOConfig,
    BOSuggester,
    EngineCache,
    RandomSuggester,
    SobolSuggester,
)
from repro_torch.core.service import (
    FactorArena,
    GPHPSamplePool,
    SelectionService,
    ServiceConfig,
)
from repro_torch.core.median_rule import MedianRule, MedianRuleConfig
from repro_torch.core.warm_start import WarmStartPool, transferable
from repro_torch.core.asha import ASHAConfig, ASHARule
from repro_torch.core.tuner import Tuner, TuningJobConfig, TuningResult

__all__ = [
    "Categorical",
    "Continuous",
    "Integer",
    "ScalingType",
    "SearchSpace",
    "ObservationStore",
    "BudgetExhaustedError",
    "BudgetLedger",
    "MetricSet",
    "MetricSpec",
    "hypervolume",
    "pareto_mask",
    "BOConfig",
    "BOSuggester",
    "EngineCache",
    "FactorArena",
    "GPHPSamplePool",
    "SelectionService",
    "ServiceConfig",
    "RandomSuggester",
    "SobolSuggester",
    "MedianRule",
    "MedianRuleConfig",
    "WarmStartPool",
    "transferable",
    "ASHAConfig",
    "ASHARule",
    "Tuner",
    "TuningJobConfig",
    "TuningResult",
]
