"""Acquisition optimization (paper §4.3), single-metric.

"the resulting pseudo-random grid [a Sobol sequence populating the search
space as densely as possible] is used as a set of anchor points to initialize
the local optimization of the EI. This scales linearly in the number of
locations and works well in practice."

Pipeline:
  1. evaluate the integrated acquisition at ``num_anchors`` Sobol points;
  2. mask anchors within ``exclusion_radius`` of pending candidates (the
     paper's "making sure not to select one of the L−1 pending candidates");
  3. take the ``num_refine`` best anchors and run projected-Adam ascent on the
     acquisition (``torch.autograd`` flows through the GP posterior),
     clipping to the unit cube;
  4. return refined candidates ranked by acquisition value.

Backends: ``AcqOptConfig.backend`` selects how stage 1 (and the final
re-ranking) scores anchors. ``"kernel"`` (the default) dispatches EI/LCB to
the fused predict+acquisition kernel (``repro_torch.kernels.acq_score``):
cross-gram, cached-inverse solve and the closed form on the card, each K*
entry computed once. ``"torch"`` is the plain composition
(``gp.predict`` + closed form). Stage 3 always evaluates through the torch
composition — the kernel has no backward pass — so the dense anchor sweep is
fused while the 8-point ascent keeps exact gradients.

The ascent is ~10³ small kernels a step, and launching them one by one
bounds it by the host. On a CUDA device, EI and LCB therefore replay it
from one CUDA graph per static shape (``_GraphedAscent``; the reference
jits its ``lax.scan`` per static shape): the same kernels in the same order,
on buffers the decision's tensors are copied into. The process keeps its
graphs least recently used first, within ``GRAPH_CACHE_BYTES``. Thompson sampling
uploads host normals inside the loop, and the multi-metric pipeline has no
graph yet; they, and every CPU call, run the eager body.

Ranking ties (anchors masked to −inf tie often) resolve to the lower index
first, as ``jax.lax.top_k`` and ``jnp.argsort`` do: a stable sort on the
negated values.

``optimize_acquisition_multi`` runs the same pipeline on the multi-head
acquisitions (constrained EI, random-scalarization EI, rung-weighted EI and
EI-per-unit-cost) over the shared-factor posterior: the anchor sweep and the
final re-rank through the fused ``acq_score_multi`` kernel, the refinement
through the torch composition. In the per-head layout (``per_head_gphp``:
one GPHP chain and one factor per head) every head predicts through its own
factor, so the variances differ by head and the shared-variance kernel does
not apply: the anchor sweep and the refinement both go through the torch
composition there, as in the JAX package.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import acquisition as A
from repro_torch.core import prng, telemetry
from repro_torch.core.device import CAPTURE_LOCK
from repro_torch.core.gp.gp import GPPosterior, predict
from repro_torch.core.gp.params import GPHyperParams
from repro_torch.core.multimetric.acquisition import constrained_ei, scalarized_ei

__all__ = [
    "AcqOptConfig",
    "MultiMetricHead",
    "optimize_acquisition",
    "optimize_acquisition_multi",
]


class AcqOptConfig(NamedTuple):
    acq: str = "ei"  # "ei" | "lcb" | "ts"
    num_anchors: int = 1024
    num_refine: int = 8  # anchors promoted to gradient refinement
    refine_steps: int = 25
    refine_lr: float = 0.05
    lcb_kappa: float = 2.0
    exclusion_radius: float = 0.02  # L∞ radius (unit cube) around pending pts
    backend: str = "kernel"  # anchor scoring: "kernel" (fused) | "torch"


def _acq_values(
    post: GPPosterior,
    x: torch.Tensor,
    y_best,  # float, or a 0-d float64 tensor (the CUDA graph's buffer)
    cfg: AcqOptConfig,
    key: np.ndarray,
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """Integrated acquisition at x: (m, d) -> (m,). Larger is better.

    ``differentiable=True`` forces the torch predict+closed-form composition
    (the refinement stage needs autograd); otherwise EI/LCB on the kernel
    backend go through the fused anchor-scoring kernel."""
    if cfg.backend not in ("kernel", "torch"):
        raise ValueError(f"unknown acquisition backend {cfg.backend!r}")
    if cfg.acq in ("ei", "lcb") and cfg.backend == "kernel" and not differentiable:
        from repro_torch.kernels.acq_score.ops import acq_score

        vals = acq_score(post, x, y_best, acq=cfg.acq, kappa=cfg.lcb_kappa)
        return A.integrate_over_samples(vals)
    mu, var = predict(post, x, backend="torch" if differentiable else cfg.backend)
    if cfg.acq == "ei":
        vals = A.expected_improvement(mu, var, y_best)
    elif cfg.acq == "lcb":
        vals = A.lcb(mu, var, cfg.lcb_kappa)
    elif cfg.acq == "ts":
        # Thompson: negative draws so larger is better; the argmax anchor is
        # the Thompson-sample minimizer. The reference's refinement scores
        # one point per call, so each point there draws (S, 1) normals.
        shape = tuple(mu.shape[:-1]) + (1,) if differentiable else None
        vals = -A.thompson_draws(mu, var, key, shape)
    else:
        raise ValueError(f"unknown acquisition {cfg.acq!r}")
    return A.integrate_over_samples(vals)


def _descending(vals: torch.Tensor) -> torch.Tensor:
    """Indices of ``vals`` from largest to smallest, ties lower-index first."""
    return torch.argsort(-vals, stable=True)


def _adam_ascent(masked_acq, x0: torch.Tensor, cfg: AcqOptConfig) -> torch.Tensor:
    """Stage 3: ``cfg.refine_steps`` steps of projected Adam ascent on the
    (masked) acquisition from x0 (m, d), clipped to the unit cube. Each
    point's acquisition depends on that point only, so the gradient of the
    summed batch is the per-point gradient. Both the eager path and the
    captured one (``_GraphedAscent``) run this body."""
    x = x0.clone()
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for step in range(cfg.refine_steps):
        t = float(step)
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(
                masked_acq(xg, differentiable=True).sum(), xg
            )
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** (t + 1.0))
        vhat = v / (1.0 - 0.999 ** (t + 1.0))
        x = torch.clamp(
            x + cfg.refine_lr * mhat / (torch.sqrt(vhat) + 1e-8), 0.0, 1.0
        )
    return x


def _refine_and_rank(
    masked_acq,
    anchors: torch.Tensor,
    cfg: AcqOptConfig,
    ascent=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 2–4 of the pipeline: top-k anchors → projected-Adam ascent on
    the (masked) acquisition → re-rank. ``masked_acq(x, differentiable)``
    scores (m, d) → (m,), larger is better. ``ascent(x0) -> x`` runs stage
    3 in place of the eager ``_adam_ascent`` (the CUDA graph's replay).

    Each stage is a span (``acq.anchors``, ``acq.refine``, ``acq.rerank``)
    that, with telemetry on, waits for the card before it closes."""
    dev = anchors.device
    with telemetry.device_span("acq.anchors", dev):
        with torch.no_grad():
            anchor_vals = masked_acq(anchors)  # (num_anchors,)
        top_idx = _descending(anchor_vals)[: cfg.num_refine]
        x0 = anchors[top_idx]  # (num_refine, d)

    with telemetry.device_span(
        "acq.refine", dev, steps=cfg.refine_steps, points=x0.shape[0]
    ):
        if ascent is None:
            telemetry.count("acq.refine.eager")
            x = _adam_ascent(masked_acq, x0, cfg)
        else:
            x = ascent(x0)

    with telemetry.device_span("acq.rerank", dev):
        with torch.no_grad():
            ref_vals = masked_acq(x)
        # A refined point may have walked into the exclusion zone; keep the
        # anchor value as fallback so ranking never returns −inf when anchors
        # were valid.
        top_vals = anchor_vals[top_idx]
        use_ref = ref_vals >= top_vals
        final_x = torch.where(use_ref[:, None], x, x0)
        final_v = torch.where(use_ref, ref_vals, top_vals)
        order = _descending(final_v)
        return final_x[order], final_v[order]


def _pending_masked(score, pending: torch.Tensor, pending_mask: torch.Tensor,
                    cfg: AcqOptConfig):
    """Wrap a scorer with the §4.4 pending-exclusion mask (L∞ radius)."""

    def masked_acq(x: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
        vals = score(x, differentiable)
        if pending.shape[0] > 0:
            # L∞ distance to every pending point
            dists = torch.amax(
                torch.abs(x[:, None, :] - pending[None, :, :]), dim=-1
            )  # (m, p)
            near = torch.any(
                (dists < cfg.exclusion_radius) & pending_mask[None, :], dim=-1
            )
            vals = torch.where(near, torch.full_like(vals, -float("inf")), vals)
        return vals

    return masked_acq


#: bytes the cached ascent graphs may hold together (their copies of the
#: inputs and their private pools); past it the least recently used go
GRAPH_CACHE_BYTES = 1 << 30


class _GraphCache:
    """The process's ascent graphs, one entry a static shape, shared by
    every job of the process and bounded by their bytes: least recently
    used first."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = budget_bytes
        self.entries: OrderedDict = OrderedDict()
        self.lock = threading.Lock()

    def get(self, key, make):
        """The entry of ``key`` (``make()`` at its first use), now the most
        recently used."""
        with self.lock:
            entry = self.entries.pop(key, None)
            self.entries[key] = make() if entry is None else entry
            return self.entries[key]

    def bound(self, keep) -> None:
        """Drop the least recently used entries, never ``keep``'s, until
        the rest fit the budget. A dropped entry that a call still holds is
        freed when that call ends."""
        with self.lock:
            total = sum(e.nbytes for e in self.entries.values())
            for key in list(self.entries):
                if total <= self.budget_bytes:
                    break
                if key != keep:
                    total -= self.entries.pop(key).nbytes
                    telemetry.count("acq.refine.graph.evict")


_GRAPHS = _GraphCache(GRAPH_CACHE_BYTES)
# the devices each thread has run the eager ascent on
_WARM = threading.local()


def _static_inputs(post: GPPosterior, pending, pending_mask, x0) -> list:
    """Every tensor the refinement's scorer reads, in a fixed order:
    the posterior's (``chol_inv`` is the fused kernel's, not read here),
    then pending, pending mask and x0."""
    return [post.x_train, post.mask, post.chol, post.alpha, *post.params,
            pending, pending_mask, x0]


def _graph_key(statics: list, cfg: AcqOptConfig) -> tuple:
    """What a capture bakes in: the device, dtype, shape and strides of
    every static input (bucket, S, d, ``num_refine``, pending rows; a
    factor's layout picks the triangular solve's variant, whose rounding
    differs at large buckets) and the configuration the body reads.
    ``y_best`` is always a 0-d float64."""
    return (statics[-1].device,
            tuple((t.dtype, tuple(t.shape), t.stride()) for t in statics),
            cfg.acq, cfg.refine_steps, cfg.refine_lr, cfg.lcb_kappa,
            cfg.exclusion_radius)


class _GraphedAscent:
    """Stage 3 of one static shape replayed from a CUDA graph.

    The graph reads only buffers this entry owns: a copy of every static
    input, in its layout, and ``y_best`` as a 0-d float64 tensor (a Python
    float would be baked into the graph as a kernel argument). Each call
    copies the decision's tensors in, replays and clones x out, all under
    the entry's lock and on the caller's current stream; the first call
    captures the body (recorded, not run) under the process's capture lock
    before its replay. A replay launches the eager body's kernels in its
    order, so its picks are the eager loop's bit for bit. ``nbytes``: the
    copies and, once captured, the graph's private pool (the allocator's
    reserved bytes across the capture)."""

    def __init__(self, statics: list, cfg: AcqOptConfig):
        self.cfg = cfg
        # in the inputs' layout (a dense input's strides are kept)
        self.bufs = [torch.empty_like(t) for t in statics]
        x_train, mask, chol, alpha, *rest = self.bufs
        nparams = len(GPHyperParams._fields)
        post = GPPosterior(x_train, mask, chol, alpha,
                           GPHyperParams(*rest[:nparams]))
        pending, pending_mask, self.x0 = rest[nparams:]
        # the scorer holds the buffers, not the entry: an entry dropped from
        # the cache is freed at once, never by a collection during a capture
        y_best = self.y_best = torch.zeros((), dtype=torch.float64,
                                           device=self.x0.device)

        def score(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
            return _acq_values(post, x, y_best, cfg, None,
                               differentiable=differentiable)

        self.masked_acq = _pending_masked(score, pending, pending_mask, cfg)
        self.graph = self.out = None
        self.nbytes = sum(b.nbytes for b in self.bufs) + y_best.nbytes
        self.lock = threading.Lock()

    def __call__(self, statics: list, y_best: float) -> torch.Tensor:
        with self.lock:
            for buf, t in zip(self.bufs, statics):
                buf.copy_(t)
            self.y_best.fill_(y_best)
            if self.graph is None:
                self._capture()
            else:
                telemetry.count("acq.refine.graph.replay")
            self.graph.replay()
            return self.out.clone()

    def _capture(self) -> None:
        telemetry.count("acq.refine.graph.capture")
        dev = self.x0.device
        warm = _WARM.__dict__.setdefault("devices", set())
        if dev not in warm:
            # a thread's first capture on a device: cuBLAS's handles,
            # autograd's device thread and the allocator warm up on one
            # eager ascent
            _adam_ascent(self.masked_acq, self.x0, self.cfg)
            warm.add(dev)
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK:
            # thread-local: other threads keep launching while this one
            # captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                self.out = _adam_ascent(self.masked_acq, self.x0, self.cfg)
            self.nbytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.graph = graph


def _graphed_ascent(post, y_best, pending, pending_mask, x0, cfg) -> torch.Tensor:
    """Stage 3 from the process's graph of this static shape (captured at
    the shape's first use)."""
    statics = _static_inputs(post, pending, pending_mask, x0)
    key = _graph_key(statics, cfg)
    x = _GRAPHS.get(key, lambda: _GraphedAscent(statics, cfg))(statics, y_best)
    _GRAPHS.bound(keep=key)
    return x


def optimize_acquisition(
    post: GPPosterior,
    anchors: torch.Tensor,  # (num_anchors, d) Sobol points in the unit cube
    y_best: float,  # best standardized observation
    pending: torch.Tensor,  # (p, d) encoded pending candidates (may be padding)
    pending_mask: torch.Tensor,  # (p,) bool
    key: np.ndarray,
    cfg: AcqOptConfig = AcqOptConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (candidates, acq_values): (num_refine, d) refined points sorted
    best-first, with pending-exclusion applied. On a CUDA device EI and LCB
    refine through the shape's CUDA graph (``_GraphedAscent``); Thompson
    draws host normals inside the loop and, like every CPU call, runs the
    eager body."""
    k_ts, _ = prng.split(key)

    def score(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        return _acq_values(post, x, y_best, cfg, k_ts,
                           differentiable=differentiable)

    masked_acq = _pending_masked(score, pending, pending_mask, cfg)
    ascent = None
    if anchors.device.type == "cuda" and cfg.acq in ("ei", "lcb"):
        def ascent(x0: torch.Tensor) -> torch.Tensor:
            return _graphed_ascent(post, y_best, pending, pending_mask, x0, cfg)
    return _refine_and_rank(masked_acq, anchors, cfg, ascent)


class MultiMetricHead(NamedTuple):
    """Per-decision state of the multi-metric acquisition: everything beyond
    the shared-factor posterior that the scorer needs. Objectives lead,
    constraints trail (the ``MetricSet`` order).

    ``weights``/``y_best_w`` are the random-scalarization draws of Pareto
    mode (empty, W=0, in constrained mode); ``y_best``/``has_feasible``
    drive constrained EI and are ignored in Pareto mode.

    ``head_posts`` is empty in the default shared-factor layout. With
    ``BOConfig.per_head_gphp`` it carries one ``GPPosterior`` per extra head
    (head 1 first), each fitted under its own GPHP chain; the scorer then
    predicts every head through its own factor (per-head variances) instead
    of the shared-factor alpha block, and ``alphas`` degenerates to the
    objective column.

    The scoring mode is passed beside the head: ``"constrained"`` and
    ``"pareto"`` as above; ``"rungs"`` is the multi-fidelity f(x, r)
    acquisition (heads [objective, rung 0, …, rung R−1], a weighted per-head
    EI); ``"cost"`` is EI-per-unit-cost (``BOConfig.cost_aware``: heads
    [objective, standardized log-cost], EI(head 0) · exp(−η · mean(head 1))
    with η in ``weights[0, 0]``)."""

    alphas: torch.Tensor  # (S, M, n) all-head K̃⁻¹y (head 0 = objective)
    t_std: torch.Tensor  # (C,) standardized signed constraint thresholds
    y_best: float  # best *feasible* standardized objective
    has_feasible: bool  # a feasible incumbent exists
    weights: torch.Tensor  # (W, K) simplex scalarization draws
    y_best_w: torch.Tensor  # (W,) best observed scalarized value per draw
    head_posts: tuple = ()  # per-head GPPosteriors (per_head_gphp only)


def _acq_values_multi(
    post: GPPosterior,
    head: MultiMetricHead,
    x: torch.Tensor,
    cfg: AcqOptConfig,
    mode: str,
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """Integrated multi-metric acquisition at x: (m, d) → (m,). The fused
    multi-head kernel serves the dense anchor sweep; gradient refinement
    always goes through the torch composition (autograd), and so does every
    score of the per-head layout."""
    from repro_torch.kernels.acq_score.ops import acq_score_multi

    if cfg.backend not in ("kernel", "torch"):
        raise ValueError(f"unknown acquisition backend {cfg.backend!r}")
    if head.head_posts:
        # per-head layout (BOConfig.per_head_gphp): every head predicts
        # through its own factor, so the variances are per head and the
        # fused shared-variance kernel does not apply
        mu0, var0 = predict(post, x, backend="torch")
        mus, vrs = [mu0], [var0]
        for hp in head.head_posts:
            muh, varh = predict(hp, x, backend="torch")
            mus.append(muh)
            vrs.append(varh)
        mu = torch.stack(mus, dim=1)  # (S, M, m)
        var = torch.stack(vrs, dim=1)  # (S, M, m) per-head variances
        if mode == "constrained":
            vals = constrained_ei(
                mu, var, head.y_best, head.t_std, head.has_feasible
            )
        else:
            vals = scalarized_ei(
                mu, var, head.weights, head.y_best_w, head.t_std
            )
        return A.integrate_over_samples(vals)
    backend = "torch" if differentiable else cfg.backend
    vals = acq_score_multi(post, head, x, mode=mode, backend=backend)
    return A.integrate_over_samples(vals)


def optimize_acquisition_multi(
    post: GPPosterior,  # shared-factor posterior (objective head resident)
    head: MultiMetricHead,
    anchors: torch.Tensor,  # (num_anchors, d) Sobol points in the unit cube
    pending: torch.Tensor,  # (p, d) encoded pending candidates (may be padding)
    pending_mask: torch.Tensor,  # (p,) bool
    key: np.ndarray,
    cfg: AcqOptConfig,
    mode: str,  # "constrained" | "pareto" | "rungs" | "cost"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-metric analogue of ``optimize_acquisition``: the same Sobol
    anchors → top-k → projected-Adam pipeline, scored by the multi-head
    acquisition of ``mode`` over the shared-factor posterior."""
    del key  # multi-metric modes are EI-based; no Thompson draws

    def score(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        return _acq_values_multi(
            post, head, x, cfg, mode, differentiable=differentiable
        )

    masked_acq = _pending_masked(score, pending, pending_mask, cfg)
    return _refine_and_rank(masked_acq, anchors, cfg)
