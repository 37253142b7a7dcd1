"""Plain reference of one GP decision of the BO engine (paper §4.2–4.4).

Written from the paper and the engine's documented semantics in plain
PyTorch; it imports nothing of the program. Given a job's history (the
configurations tried, encoded, and their raw objective values), the
configurations in flight and the S GPHP samples the decision used, it builds
the integrated-EI surface and repeats the decision:

  * targets z-scored over the observed rows (population std);
  * Kumaraswamy-warped inputs, Matérn-5/2 ARD gram, amplitude², noise² plus a
    1e-8 jitter on the diagonal; in-flight rows enter with the constant liar
    (standardized target 0), so the factor covers observed and pending rows;
  * EI of the latent f against the best standardized observation, averaged
    over the S samples;
  * the first 1024 points of the unscrambled Sobol sequence as anchors
    (scipy's Joe–Kuo generator), the 8 best refined by 25 steps of projected
    Adam (lr 0.05, β 0.9/0.999, ε 1e-8) on the averaged EI, a refined point
    kept only where it beats its anchor, then re-ranked;
  * the first candidate that, rounded to the space (integers to the nearest
    value), lies more than 1e-6 (L∞) from every observed, pending or
    already-picked row.

``dtype`` sets the precision of every step: float64 is the reference,
float32 the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.stats import qmc

SQRT5 = math.sqrt(5.0)
JITTER = 1e-8
STD_FLOOR = 1e-12
WARP_EPS = 1e-6


# ------------------------------------------------------------------ space
def encode(space: Sequence[dict], config: Dict) -> np.ndarray:
    out = np.zeros(len(space))
    for j, p in enumerate(space):
        v = float(config[p["name"]])
        lo, hi = float(p["low"]), float(p["high"])
        if p.get("scaling") == "log":
            u = (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
        else:
            u = (v - lo) / (hi - lo)
        out[j] = min(1.0, max(0.0, u))
    return out


def decode(space: Sequence[dict], u_vec: np.ndarray) -> Dict:
    out = {}
    for p, u in zip(space, u_vec):
        u = min(1.0, max(0.0, float(u)))
        lo, hi = float(p["low"]), float(p["high"])
        if p.get("scaling") == "log":
            raw = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            raw = lo + u * (hi - lo)
        if p["type"] == "integer":
            raw = int(min(int(p["high"]), max(int(p["low"]), round(raw))))
        out[p["name"]] = raw
    return out


def snap(space: Sequence[dict], u_vec: np.ndarray) -> np.ndarray:
    return encode(space, decode(space, np.clip(u_vec, 0.0, 1.0)))


def anchors(d: int, count: int) -> np.ndarray:
    return qmc.Sobol(d, scramble=False).random(count)


# -------------------------------------------------------------- posterior
class FactorError(ArithmeticError):
    """A decision's gram could not be factorized at the precision asked."""


class Posterior:
    """S exact GP posteriors over the rows ``x`` (n, d) with targets ``t``."""

    def __init__(self, x, t, samples, dtype, device):
        f = dict(dtype=dtype, device=device)
        d = x.shape[1]
        s = torch.as_tensor(samples, **f)
        self.inv_ell = torch.exp(-s[:, :d])
        self.amp2 = torch.exp(2.0 * s[:, d])
        noise = torch.exp(2.0 * s[:, d + 1]) + JITTER
        self.log_a, self.log_b = s[:, d + 2:2 * d + 2], s[:, 2 * d + 2:3 * d + 2]
        self.x = torch.as_tensor(x, **f)
        k = self.gram(self.x)  # (S, n, n)
        k = k + noise[:, None, None] * torch.eye(len(x), **f)
        self.chol, info = torch.linalg.cholesky_ex(k)
        if bool((info != 0).any()):
            raise FactorError(f"the gram of {len(x)} rows is not positive definite in {dtype}")
        tt = torch.as_tensor(t, **f)[None, :, None].expand(len(s), -1, 1)
        self.alpha = torch.cholesky_solve(tt, self.chol)[..., 0]  # (S, n)

    def warp(self, x):
        """x (m, d) -> (S, m, d), the Kumaraswamy CDF per sample."""
        a, b = torch.exp(self.log_a)[:, None, :], torch.exp(self.log_b)[:, None, :]
        xc = torch.clamp(x, WARP_EPS, 1.0 - WARP_EPS)[None]
        xa = torch.clamp(torch.exp(a * torch.log(xc)), WARP_EPS, 1.0 - WARP_EPS)
        w = 1.0 - torch.exp(b * torch.log1p(-xa))
        ident = ((self.log_a.abs() < 1e-7) & (self.log_b.abs() < 1e-7))[:, None, :]
        return torch.where(ident, x[None].expand_as(w), w)

    def gram(self, x2):
        """k(rows, x2): (S, n, m)."""
        w1 = self.warp(self.x) * self.inv_ell[:, None, :]
        w2 = self.warp(x2) * self.inv_ell[:, None, :]
        diff = w1[:, :, None, :] - w2[:, None, :, :]
        r2 = (diff * diff).sum(-1)
        r = torch.sqrt(torch.clamp_min(r2, 1e-30))
        return self.amp2[:, None, None] * (1.0 + SQRT5 * r + (5.0 / 3.0) * r2) * torch.exp(-SQRT5 * r)

    def ei(self, x, y_best):
        """Integrated EI at x (m, d): (m,)."""
        ks = self.gram(x)
        mu = (ks * self.alpha[:, :, None]).sum(1)
        v = torch.linalg.solve_triangular(self.chol, ks, upper=False)
        var = torch.clamp_min(self.amp2[:, None] - (v * v).sum(1), 1e-12)
        sigma = torch.sqrt(torch.clamp_min(var, 1e-16))
        g = (y_best - mu) / sigma
        cdf = 0.5 * (1.0 + torch.erf(g / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * g * g) / math.sqrt(2.0 * math.pi)
        ei = torch.clamp_min(sigma * (g * cdf + pdf), 0.0)
        return ei.mean(0)


def standardize(y: np.ndarray) -> np.ndarray:
    mean, std = float(y.mean()), float(y.std())
    return (y - mean) / (std if std > STD_FLOOR else 1.0)


def posterior(x_obs, y_obs, pending, samples, liar, dtype, device):
    """The decision's posterior: observed rows, then pending rows at the liar."""
    z = standardize(np.asarray(y_obs, dtype=np.float64))
    rows = np.concatenate([x_obs, pending]) if len(pending) else np.asarray(x_obs)
    t = np.concatenate([z, np.full(len(pending), liar)])
    return Posterior(rows, t, samples, dtype, device), float(z.min())


# --------------------------------------------------------------- decision
def refine(post, y_best, anchor_x, num_refine, steps, lr):
    """Top anchors, projected Adam on the integrated EI, re-rank."""
    with torch.no_grad():
        vals = post.ei(anchor_x, y_best)
    top = torch.argsort(-vals, stable=True)[:num_refine]
    x0 = anchor_x[top]
    x, m, v = x0.clone(), torch.zeros_like(x0), torch.zeros_like(x0)
    for step in range(steps):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(post.ei(xg, y_best).sum(), xg)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** (step + 1.0))
        vhat = v / (1.0 - 0.999 ** (step + 1.0))
        x = torch.clamp(x + lr * mhat / (torch.sqrt(vhat) + 1e-8), 0.0, 1.0)
    with torch.no_grad():
        ref = post.ei(x, y_best)
    top_vals = vals[top]
    use = ref >= top_vals
    fx = torch.where(use[:, None], x, x0)
    fv = torch.where(use, ref, top_vals)
    order = torch.argsort(-fv, stable=True)
    return fx[order]


def decide(space, engine, x_obs, y_obs, pending, samples, k, dtype=torch.float64,
           device="cpu") -> List[np.ndarray]:
    """The k encoded configurations one decision returns."""
    liar = float(engine["liar_value"])
    acq = engine["acq"]
    anchor_x = torch.as_tensor(anchors(len(space), acq["num_anchors"]), dtype=dtype,
                               device=device)
    pend = np.asarray(pending, dtype=np.float64).reshape(-1, len(space))
    picks: List[np.ndarray] = []
    for _ in range(k):
        fold = np.concatenate([pend] + [p[None] for p in picks]) if picks else pend
        post, y_best = posterior(x_obs, y_obs, fold, samples, liar, dtype, device)
        cands = refine(post, y_best, anchor_x, acq["num_refine"], acq["refine_steps"],
                       acq["refine_lr"]).double().cpu().numpy()
        seen = np.concatenate([np.asarray(x_obs), fold])
        chosen = None
        for c in cands:
            s = snap(space, c)
            if np.min(np.max(np.abs(seen - s[None]), axis=1)) > engine["dedupe_tol"]:
                chosen = s
                break
        if chosen is None:  # every candidate seen: the engine falls back to Sobol
            chosen = np.full(len(space), np.nan)
        picks.append(chosen)
    return picks


def ei_gap(space, engine, x_obs, y_obs, pending, samples, got, want, device="cpu"):
    """Shortfall of the integrated EI (float64) at the program's pick ``got``
    behind the reference's pick ``want``, relative to the reference's: 0
    when the program's pick is as good or better. ``got``/``want`` are the
    first pick of the decision (the later picks of a batch condition on it)."""
    post, y_best = posterior(x_obs, y_obs, np.asarray(pending).reshape(-1, len(space)),
                             samples, float(engine["liar_value"]), torch.float64, device)
    with torch.no_grad():
        vals = post.ei(torch.as_tensor(np.stack([got, want]), dtype=torch.float64,
                                       device=device), y_best).cpu().numpy()
    best = max(vals[1], 1e-300)
    return max(0.0, float((vals[1] - vals[0]) / best))


def cold_start(space, seed: int, count: int) -> np.ndarray:
    """The first ``count`` cold-start picks of a job seeded ``seed``: the
    unscrambled Sobol sequence under a digital shift of 30 random bits a
    dimension (drawn by ``numpy.random.default_rng(seed)``), each rounded to
    the space, skipping a point within 1e-6 (L∞) of an earlier pick."""
    d = len(space)
    shift = np.random.default_rng(seed).integers(0, 1 << 30, size=d, dtype=np.uint64)
    m = max(5, int(math.ceil(math.log2(4 * count + 32))))
    ints = (qmc.Sobol(d, scramble=False).random_base2(m) * 2.0**30).astype(np.uint64)
    seq = iter((ints ^ shift[None, :]).astype(np.float64) * 2.0**-30)
    picks: List[np.ndarray] = []
    while len(picks) < count:
        s = snap(space, next(seq))
        if not picks or np.min(np.max(np.abs(np.array(picks) - s[None]), axis=1)) > 1e-6:
            picks.append(s)
    return np.array(picks)
