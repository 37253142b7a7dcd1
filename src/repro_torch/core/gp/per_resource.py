"""Per-rung GP heads over the shared factor: the f(x, r) posterior.

The multi-fidelity engine models the objective *at each rung* r = r_min·η^k
as its own GP head — the shape of syne-tune's independent-per-resource
posterior state — but, exactly like the multi-metric heads of
``repro_torch.core.gp.multi``, every head shares ONE Cholesky/L⁻¹ factor: the
kernel depends only on X and the GPHPs, never on targets, so a rung head
costs one extra alpha solve per decision plus one matvec inside scoring.
Head 0 stays the final/cummin objective driving the exact single-metric
machinery (GPHP chain, rank-1 appends, refit cadence, snapshots) — with
multi-fidelity off no head is ever built and the engine is bit-identical.

Head targets are a pure function of (store rows + keys, rung tables), so
the factor/alpha state inherits every replay-rehydration invariant for
free: arena eviction, snapshot restore, and SIGKILL failover all rebuild
the same heads from the same replayed inputs.

Imputation: a store row whose trial never crossed rung k (stopped earlier,
warm-start parent, key-less push) contributes its final standardized
objective to head k — every head is a dense column, so the shared factor
needs no per-head masks. Observed rung values are z-scored per head over
the rows that actually crossed the rung.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch

from repro_torch.core.acquisition import expected_improvement

__all__ = [
    "rung_head_targets",
    "rung_head_weights",
    "rung_weighted_ei",
]

_STD_FLOOR = 1e-12


def rung_head_targets(
    store, rungs: Mapping[int, Mapping], num_rungs: int, y_std: np.ndarray
) -> np.ndarray:
    """Build the (R, n) rung-head target matrix in standardized space.

    Args:
        store: the job's ``ObservationStore`` (row keys join rung tables).
        rungs: rung index -> {trial key: signed running-best value} — the
            ``MultiFidelityState`` tables.
        num_rungs: how many rung heads to build (``num_active_rungs``).
        y_std: the store's standardized objective vector (length ≥ n) —
            the imputation value for rows without a rung-k observation.
    """
    n = store.num_observations
    npar = store.num_parents
    keys = store.own_keys()
    out = np.tile(np.asarray(y_std[:n], dtype=np.float64)[None, :], (num_rungs, 1))
    for k in range(num_rungs):
        table = rungs.get(k) or {}
        if not table:
            continue
        idxs: List[int] = []
        vals: List[float] = []
        for j, key in enumerate(keys):
            if key is not None and key in table:
                idxs.append(npar + j)
                vals.append(float(table[key]))
        if len(vals) >= 2:
            v = np.asarray(vals, dtype=np.float64)
            mean = float(v.mean())
            std = float(v.std())
            scale = std if std > _STD_FLOOR else 1.0
            out[k, idxs] = (v - mean) / scale
        elif len(vals) == 1:
            out[k, idxs[0]] = 0.0  # single observation: its z-score is 0
    return out


def rung_head_weights(
    rung_grid: List[int], num_rungs: int, objective_weight: float = 0.5
) -> np.ndarray:
    """(1, R+1) acquisition weight row over [objective, rung 0, …, rung R−1].

    The objective head keeps ``objective_weight``; the remainder is split
    across rung heads proportionally to their resource level r_k — high
    rungs are closer to the final objective and carry more signal, low
    rungs mostly de-duplicate configs that die early. Deterministic (no
    RNG), so the acquisition stays replay-stable."""
    if num_rungs == 0:
        return np.ones((1, 1), dtype=np.float64)
    r = np.asarray(rung_grid[:num_rungs], dtype=np.float64)
    w = r / r.sum() * (1.0 - objective_weight)
    return np.concatenate(([objective_weight], w))[None, :]


def rung_weighted_ei(
    mu: torch.Tensor,  # (S, M, m) per-head means; head 0 = objective
    var: torch.Tensor,  # (S, m) shared variance
    y_best_heads: torch.Tensor,  # (M,) per-head standardized incumbents
    weights: torch.Tensor,  # (M,) acquisition weight per head
) -> torch.Tensor:
    """Σ_h w_h · EI_h(x) per (sample, anchor): (S, m). Each head scores EI
    against its own incumbent; the weighted sum trades final-objective
    improvement against cheap-fidelity information. Closed-form torch, so
    autograd flows through for anchor refinement; the fused CUDA analogue
    is the ``"rungs"`` mode of ``repro_torch.kernels.acq_score``."""
    ei = expected_improvement(
        mu, var[:, None, :], y_best_heads[None, :, None]
    )  # (S, M, m)
    return torch.einsum("h,shm->sm", weights, ei)
