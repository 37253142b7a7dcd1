"""Core of the port: search space, observation store, BO engine, tuner.

The decision loop of the JAX reference (``repro.core``) in PyTorch:
single-metric, multi-metric (constrained and Pareto) and cost-aware jobs,
with budgets. Unlike the reference's package, importing this one flips no
global switch: every tensor names its dtype (float64 for the GP/BO
numerics) and its device. The multi-job service, multi-fidelity and the
early-stopping rules wait (see ROADMAP.md, queue A).
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
from repro_torch.core.warm_start import WarmStartPool, transferable
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
    "RandomSuggester",
    "SobolSuggester",
    "WarmStartPool",
    "transferable",
    "Tuner",
    "TuningJobConfig",
    "TuningResult",
]
